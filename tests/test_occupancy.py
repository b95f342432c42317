"""Occupancy-guided sampling (ops/occupancy.py): the static-shape
empty-space skip — static sample count, samples moved into occupied
space through the inverse CDF."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.ops.occupancy import (
    OccupancyGrid,
    bake_occupancy,
    occupancy_t,
    sigma_field,
)

NEAR, FAR = 2.0, 6.0


def _sphere_sigma(center, radius):
    def fn(pts):
        return jnp.where(
            jnp.linalg.norm(pts - jnp.asarray(center), axis=-1) < radius,
            10.0, 0.0,
        )
    return fn


def test_bake_marks_sphere_and_dilates():
    dom = (-1.0, 1.0)
    fn = _sphere_sigma([0.0, 0.0, 0.0], 0.4)
    occ0 = bake_occupancy(fn, grid_res=16, domain=dom, dilate=0)
    occ1 = bake_occupancy(fn, grid_res=16, domain=dom, dilate=1)
    assert occ0.shape == (16, 16, 16, 1)
    inside = float(occ0[8, 8, 8, 0])
    corner = float(occ0[0, 0, 0, 0])
    assert inside == 1.0 and corner == 0.0
    # dilation grows the occupied set, never shrinks it
    assert float(jnp.sum(occ1)) > float(jnp.sum(occ0))
    assert float(jnp.min(occ1 - occ0)) >= 0.0


def test_sigma_field_adapter():
    def apply_fn(params, pts, dirs):
        del params, dirs
        return jnp.zeros(pts.shape[:-1] + (3,)), jnp.sum(pts, axis=-1)

    fn = sigma_field(apply_fn, None)
    out = fn(jnp.ones((4, 3)))
    np.testing.assert_allclose(np.asarray(out), 3.0)


def _slab_occ(num_bins=64):
    """Occupied only for z in [0.25, 0.5] of the unit cube (internal
    coords z in [-0.5, 0.0])."""
    g = np.zeros((16, 16, 16, 1), np.float32)
    g[:, :, 4:8] = 1.0
    return OccupancyGrid(grid=jnp.asarray(g), domain=(-1.0, 1.0),
                         num_bins=num_bins, floor=1e-3)


def test_occupancy_t_concentrates_and_stays_sorted():
    occ = _slab_occ()
    n = 32
    # rays marching +z (normalize=False: ray points ARE the model-input
    # coords): z = -3 + 0.5 t for t in [2, 6] covers z in [-2, 0]; the
    # occupied cells 4..7 of 16 span z in [-0.47, -0.07], i.e. t in
    # ~[5.07, 5.87] (tent interpolation spills one cell outward).
    o = jnp.concatenate(
        [jnp.zeros((n, 2)), jnp.full((n, 1), -3.0)], axis=-1)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.5]), (n, 3))
    t = occupancy_t(jax.random.key(0), occ, o, d, NEAR, FAR, 16,
                    normalize=False, perturb=True)
    assert t.shape == (n, 16)
    tn = np.asarray(t)
    assert (np.diff(tn, axis=-1) >= 0).all(), "t must be monotonic"
    assert (tn >= NEAR).all() and (tn <= FAR).all()
    frac_inside = ((tn >= 4.9) & (tn <= 6.0)).mean()
    assert frac_inside > 0.8, frac_inside  # floor leaks a little by design


def test_floor_keeps_empty_rays_spread():
    occ = OccupancyGrid(grid=jnp.zeros((8, 8, 8, 1)), domain=(-1.0, 1.0),
                        num_bins=32, floor=1e-2)
    o = jnp.zeros((8, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (8, 3))
    t = occupancy_t(jax.random.key(1), occ, o, d, NEAR, FAR, 32,
                    normalize=True, perturb=False)
    tn = np.asarray(t)
    # all-floor weights = uniform pdf: samples span most of [near, far]
    assert tn.min() < NEAR + 0.3 and tn.max() > FAR - 0.3


def test_train_step_with_occupancy_grid():
    """The step accepts a traced occ_grid and samples differently under
    it (same PRNG stream, different coarse t placement)."""
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.models.nerf import NeRFModel
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    model = NeRFModel(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    params = model.init(jax.random.key(0))
    tx = make_optimizer(Config())
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       fine_params={}, opt_state=tx.init((params, {})))
    settings = RenderSettings(near=NEAR, far=FAR, num_samples=8,
                              white_background=False)
    k = jax.random.key(1)
    d = jax.random.normal(k, (128, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    pool = RayPool(rays_o=jnp.zeros((128, 3)), rays_d=d,
                   rgb=jax.random.uniform(k, (128, 3)), viewdirs=d)
    dom = (-2.75, -1.25)
    step = make_train_step(model, tx, settings, 64, jax.random.key(2),
                           donate=False,
                           occupancy_opts=(dom, 32, 1e-2))
    occ = jnp.ones((8, 8, 8, 1), jnp.float32)
    _, m_occ = step(state, pool, occ)
    _, m_none = step(state, pool, None)
    assert np.isfinite(float(m_occ["loss"]))
    # a lovely exactness property: an all-occupied prior makes the inverse
    # CDF collapse to near + (far-near)*u with the SAME key and stratified
    # quantiles — i.e. occupancy-on with a fresh (all-occupied, density-
    # bias-init) bake trains BIT-IDENTICALLY to plain stratified sampling
    np.testing.assert_allclose(float(m_occ["mse"]), float(m_none["mse"]),
                               rtol=1e-6)
    # ...and a non-uniform prior actually moves the samples
    slab = jnp.zeros((8, 8, 8, 1), jnp.float32).at[:, :, 3:5].set(1.0)
    _, m_slab = step(state, pool, slab)
    assert np.isfinite(float(m_slab["loss"]))
    assert abs(float(m_slab["mse"]) - float(m_none["mse"])) > 1e-9


def test_fit_occupancy_guided_training(tmp_path):
    """fit() bakes, rebakes at the interval, and converges."""
    from nerf_jax.config import Config
    from nerf_jax.train.loop import fit
    from tests.synthetic import make_synthetic_blender_scene

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    cfg = Config(
        dataset_path=str(root), model_type="nerf", hidden_dim=32,
        pos_encoding_dim=2, dir_encoding_dim=1, num_samples=8,
        num_random_rays=64, donate_state=False,
        occupancy_res=8, occupancy_interval=4,
        log_interval=4, val_interval=100, save_interval=100,
        save_path=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
    )
    state = fit(cfg, max_steps=10, enable_tensorboard=False)
    assert int(state.step) == 10


def test_render_quality_beats_uniform_at_small_sample_count():
    """The feature's point: with the sample budget cut 4x, occupancy-guided
    sampling stays close to the dense render while uniform stratification
    degrades more."""
    from nerf_jax.models.plenoxels import PlenoxelsModel
    from nerf_jax.render.renderer import RenderSettings, render_rays

    dom = (-2.75, -1.25)
    model = PlenoxelsModel(grid_res=32, domain=dom)
    params = model.init(jax.random.key(0))
    # a solid ball in the domain center, red-ish SH DC
    lin = np.linspace(dom[0], dom[1], 32, dtype=np.float32)
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    c = 0.5 * (dom[0] + dom[1])
    inside = (np.sqrt((xx - c) ** 2 + (yy - c) ** 2 + (zz - c) ** 2)
              < 0.3).astype(np.float32)
    g = np.array(params["grid"])  # writable copy
    g[..., 0] = 20.0 * inside - 5.0 * (1 - inside)
    g[..., 1] = 2.0 * inside   # R channel DC coefficient
    params = {"grid": jnp.asarray(g)}

    occ = OccupancyGrid(
        grid=bake_occupancy(
            sigma_field(model.apply, params), grid_res=32, domain=dom),
        domain=dom, num_bins=64,
    )
    n = 64
    # camera at world (0,0,-4) marching +z: t in [2,6] covers world
    # z in [-2,2], crossing the ball (world origin = the domain center
    # under the [near,far]->[-1,1] map) at t = 4
    o = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -4.0]), (n, 3))
    ang = jnp.linspace(-0.1, 0.1, n)
    d = jnp.stack([jnp.sin(ang), jnp.zeros((n,)), jnp.cos(ang)], axis=-1)
    st = lambda s: RenderSettings(near=NEAR, far=FAR, num_samples=s,
                                  perturb=False, white_background=False)
    key = jax.random.key(3)
    ref = render_rays(model.apply, params, o, d, key, st(256))
    uni = render_rays(model.apply, params, o, d, key, st(16))
    gui = render_rays(model.apply, params, o, d, key, st(16), occupancy=occ)
    err_uni = float(jnp.mean((uni.rgb - ref.rgb) ** 2))
    err_gui = float(jnp.mean((gui.rgb - ref.rgb) ** 2))
    assert err_gui < 0.5 * err_uni, (err_uni, err_gui)
