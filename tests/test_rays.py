"""Ray generation and pose synthesis golden tests (SURVEY.md §4: ray
directions for known poses per data.py:96-109; focal per data.py:60;
spherical pose matrices per eval.py:14-41)."""

import numpy as np

from nerf_jax.data.poses import pose_spherical, spherical_orbit
from nerf_jax.data.rays import compute_rays, compute_rays_single


def test_identity_pose_center_ray():
    h = w = 4
    focal = 10.0
    images = np.zeros((1, h, w, 3), np.float32)
    c2w = np.eye(4, dtype=np.float32)[None]
    rays_o, rays_d, tp = compute_rays(images, c2w, focal)
    assert rays_o.shape == rays_d.shape == tp.shape == (1, h * w, 3)
    np.testing.assert_allclose(rays_o, 0.0)
    # unit length
    np.testing.assert_allclose(np.linalg.norm(rays_d, axis=-1), 1.0, atol=1e-6)
    # pixel (u=0, v=0): dir before normalize = (0-2, -(0-2), -10) = (-2, 2, -10)
    d00 = np.array([-2.0, 2.0, -10.0])
    np.testing.assert_allclose(rays_d[0, 0], d00 / np.linalg.norm(d00), atol=1e-6)
    # all z-components negative for identity pose looking down -z
    assert (rays_d[0, :, 2] < 0).all()


def test_translated_pose_origins():
    images = np.zeros((1, 2, 2, 3), np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [1.0, 2.0, 3.0]
    rays_o, _, _ = compute_rays(images, c2w[None], 5.0)
    np.testing.assert_allclose(rays_o[0], [[1.0, 2.0, 3.0]] * 4)


def test_rotation_is_applied():
    # 90 deg rotation about y: camera -z maps to world -x.
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32).T
    images = np.zeros((1, 3, 3, 3), np.float32)
    rays_o, rays_d, _ = compute_rays(images, c2w[None], 100.0)
    center = rays_d[0, 4]  # center-ish pixel
    assert center[0] < -0.9  # looking down world -x


def test_compute_rays_single_matches_batch():
    h, w, focal = 5, 7, 9.0
    rng = np.random.default_rng(0)
    c2w = np.eye(4, dtype=np.float32)
    # random rotation via QR
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w[:3, :3] = q.astype(np.float32)
    c2w[:3, 3] = rng.normal(size=3).astype(np.float32)
    images = np.zeros((1, h, w, 3), np.float32)
    ro_b, rd_b, _ = compute_rays(images, c2w[None], focal)
    ro_s, rd_s = compute_rays_single(h, w, focal, c2w)
    np.testing.assert_allclose(ro_s, ro_b[0], atol=1e-6)
    np.testing.assert_allclose(rd_s, rd_b[0], atol=1e-5)


def test_focal_formula():
    # focal = 0.5 * W / tan(0.5 * camera_angle_x) (data.py:60)
    camera_angle_x = 0.6911112070083618  # standard Blender synthetic
    w = 800
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    assert abs(focal - 1111.1110311937682) < 1e-6


def test_pose_spherical_reference_values():
    # theta=0, phi=0, r=4: axis-swap @ translate(4)
    p = pose_spherical(0.0, 0.0, 4.0)
    want = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 4], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
    )
    np.testing.assert_allclose(p, want, atol=1e-6)
    # radius preserved for any angles
    p2 = pose_spherical(37.0, -30.0, 4.0)
    assert abs(np.linalg.norm(p2[:3, 3]) - 4.0) < 1e-5
    # rotation block orthonormal
    r = p2[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)


def test_spherical_orbit_count_and_spread():
    poses = spherical_orbit(8)
    assert poses.shape == (8, 4, 4)
    # distinct azimuths: the orbit circle lives in the (x, y) plane after the
    # axis swap (z = -r*sin(phi) is constant)
    xy = poses[:, :3, 3][:, [0, 1]]
    assert np.unique(np.round(xy, 4), axis=0).shape[0] == 8
    assert np.ptp(poses[:, 2, 3]) < 1e-5
