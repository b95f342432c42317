"""Synthetic Blender-format dataset generator for tests and smoke runs.

Ray-traces a small lambertian-ish sphere (center origin, radius 1, flat RGB
color modulated by the surface normal) from an orbit of cameras and writes
standard NeRF Blender files: ``transforms_{split}.json`` + RGBA PNGs. The
scene is 3-D-consistent, so a NeRF trained on it converges quickly — ideal
for end-to-end integration tests without shipping datasets.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_jax.data.poses import pose_spherical
from nerf_jax.data.rays import compute_rays_single
from nerf_jax.utils.png import write_png

CAMERA_ANGLE_X = 0.6911112070083618  # standard Blender synthetic FOV


SPHERE_RGB = (0.9, 0.3, 0.2)


def render_sphere_image(
    h: int, w: int, c2w: np.ndarray, radius: float = 1.0,
    color=SPHERE_RGB,
) -> np.ndarray:
    """Returns an RGBA float image in [0,1] of the test sphere."""
    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    rays_o, rays_d = compute_rays_single(h, w, focal, c2w)

    # ray-sphere intersection: |o + t d|^2 = r^2
    b = 2.0 * np.sum(rays_o * rays_d, axis=-1)
    c = np.sum(rays_o * rays_o, axis=-1) - radius**2
    disc = b * b - 4 * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit &= t > 0

    p = rays_o + t[:, None] * rays_d
    normal = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    base = np.array(color, np.float32)
    shade = 0.5 + 0.5 * np.clip(normal @ np.array([0.3, 0.5, 0.8]), -1, 1)
    rgb = base[None, :] * shade[:, None]

    img = np.zeros((h * w, 4), np.float32)
    img[hit, :3] = np.clip(rgb[hit], 0, 1)
    img[hit, 3] = 1.0
    return img.reshape(h, w, 4)


def make_synthetic_llff_scene(
    root: str,
    h: int = 32,
    w: int = 40,
    num_images: int = 12,
    radius: float = 4.0,
) -> str:
    """Write a forward-facing LLFF-format scene (poses_bounds.npy + images/)
    of the test sphere. Cameras sit near (0, 0, radius) looking down -z with
    small lateral offsets — the standard LLFF capture geometry."""
    rng = np.random.default_rng(1)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    rows = []
    for i in range(num_images):
        # camera basis: right/up/back with tiny rotations toward the origin
        offset = rng.uniform(-0.4, 0.4, size=2)
        t = np.array([offset[0], offset[1], radius], np.float32)
        back = t / np.linalg.norm(t)  # look at the origin
        right = np.cross(np.array([0.0, 1.0, 0.0]), back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, t

        img = render_sphere_image(h, w, c2w)
        rgb = img[..., :3] * img[..., 3:4]  # over black
        write_png(
            os.path.join(img_dir, f"img_{i:03d}.png"),
            (rgb * 255).astype(np.uint8),
        )
        # LLFF stores [down, right, back] columns: down = -up
        m = np.stack([-up, right, back, t], axis=1)  # (3, 4)
        hwf = np.array([[h], [w], [focal]], np.float32)
        rows.append(
            np.concatenate(
                [np.concatenate([m, hwf], axis=1).reshape(-1),
                 [radius - 1.5, radius + 1.5]]
            )
        )
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return root


def make_synthetic_blender_scene(
    root: str,
    h: int = 40,
    w: int = 40,
    num_train: int = 12,
    num_val: int = 2,
    num_test: int = 2,
    seed: int = 0,
) -> str:
    """Write a complete Blender-format scene under ``root``; returns root.
    ``seed`` jitters the camera orbit and rotates the sphere's colour, so
    two seeds give two different scenes."""
    rng = np.random.default_rng(seed)
    color = np.roll(SPHERE_RGB, seed)
    os.makedirs(root, exist_ok=True)
    counts = {"train": num_train, "val": num_val, "test": num_test}
    for split, n in counts.items():
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        thetas = np.linspace(-180, 180, n + 1)[:-1] + rng.uniform(0, 5)
        phis = -30.0 + rng.uniform(-10, 10, size=n)
        for i, (theta, phi) in enumerate(zip(thetas, phis)):
            c2w = pose_spherical(float(theta), float(phi), 4.0)
            img = render_sphere_image(h, w, c2w, color=color)
            rel = f"./{split}/r_{i}"
            write_png(
                os.path.join(root, f"{rel.lstrip('./')}.png"),
                (img * 255).astype(np.uint8),
            )
            frames.append(
                {"file_path": rel, "transform_matrix": c2w.tolist()}
            )
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return root
