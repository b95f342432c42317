"""Grid-family domain placement (models/registry.py::grid_domain).

The reference's componentwise [near,far] -> [-1,1] position map
(rendering.py:67-107) sends scene content near the world origin to about
-2*near/(far-near) - 1 (≈ -2 at the default near=2/far=6) — OUTSIDE the
[-1,1]^3 cube the grid families' voxel/hash structures natively cover.
These tests pin the fix: grid models carry a ``domain`` cube sized to the
normalized image of the [-scene_bound, scene_bound]^3 world volume and
remap internally, so the scene actually lands inside the grid.
"""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.config import Config
from nerf_jax.models.common import remap_domain
from nerf_jax.models.fastnerf import FastNeRFModel
from nerf_jax.models.kilonerf import KiloNeRFModel
from nerf_jax.models.ngp import NGPModel
from nerf_jax.models.plenoctree import PlenOctreeModel
from nerf_jax.models.plenoxels import PlenoxelsModel
from nerf_jax.models.registry import grid_domain, model_from_config
from nerf_jax.ops.sampling import normalize_positions


def _pts(n=64, lo=-2.75, hi=-1.25, seed=0):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.uniform(lo, hi, size=(n, 3)).astype(np.float32))


def _dirs(n=64, seed=1):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))


# ------------------------------------------------------------- the mapping


def test_remap_domain_identity_and_affine():
    p = _pts()
    assert remap_domain(p, (-1.0, 1.0)) is p  # identity short-circuits
    out = remap_domain(p, (-3.0, 1.0))
    np.testing.assert_allclose(
        np.asarray(out), (np.asarray(p) + 3.0) / 2.0 - 1.0, rtol=1e-6)
    # endpoints hit the cube corners exactly
    np.testing.assert_allclose(
        np.asarray(remap_domain(jnp.asarray([-3.0, 1.0]), (-3.0, 1.0))),
        [-1.0, 1.0], atol=1e-6)


def test_grid_domain_covers_scene_content():
    cfg = Config()  # near=2, far=6, scene_bound=1.5
    lo, hi = grid_domain(cfg)
    np.testing.assert_allclose([lo, hi], [-2.75, -1.25], atol=1e-6)
    # the normalized image of every world point within |xyz| <= scene_bound
    # falls inside the domain — the very property the old [-1,1] assumption
    # violated (world origin -> -2)
    w = np.asarray([[0.0, 0.0, 0.0], [1.5, -1.5, 0.7], [-1.5, 1.5, -1.5]])
    p = np.asarray(normalize_positions(jnp.asarray(w), cfg.near, cfg.far))
    assert (p >= lo - 1e-6).all() and (p <= hi + 1e-6).all()


def test_grid_domain_ndc_is_unit_cube():
    cfg = Config(dataset_type="llff", ndc=True)
    assert grid_domain(cfg) == (-1.0, 1.0)


def test_model_from_config_injects_domain():
    cfg = Config(model_type="plenoxels", grid_res=8)
    model = model_from_config(cfg)
    assert model.domain == grid_domain(cfg)
    # MLP families have no domain field and must not receive it
    nerf = model_from_config(Config(model_type="nerf"))
    assert not hasattr(nerf, "domain")


# -------------------------------------------- per-family domain equivalence
# a model with domain D at points p must equal the default-domain model at
# remap_domain(p, D): the domain is an input affine, nothing else


def test_plenoxels_domain_equivalence():
    dom = (-2.75, -1.25)
    kw = dict(grid_res=8)
    m_dom = PlenoxelsModel(domain=dom, **kw)
    m_ref = PlenoxelsModel(**kw)
    params = m_dom.init(jax.random.key(0))
    params["grid"] = jax.random.normal(
        jax.random.key(1), params["grid"].shape) * 0.5
    p, d = _pts(), _dirs()
    rgb_a, sig_a = m_dom.apply(params, p, d)
    rgb_b, sig_b = m_ref.apply(params, remap_domain(p, dom), d)
    np.testing.assert_allclose(np.asarray(rgb_a), np.asarray(rgb_b), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sig_a), np.asarray(sig_b), atol=1e-6)


def test_kilonerf_domain_equivalence():
    dom = (-2.75, -1.25)
    m_dom = KiloNeRFModel(grid_res=4, hidden_dim=16, domain=dom)
    m_ref = KiloNeRFModel(grid_res=4, hidden_dim=16)
    p = _pts()
    vid_a, loc_a = m_dom.voxel_of(p)
    vid_b, loc_b = m_ref.voxel_of(remap_domain(p, dom))
    np.testing.assert_array_equal(np.asarray(vid_a), np.asarray(vid_b))
    np.testing.assert_allclose(np.asarray(loc_a), np.asarray(loc_b), atol=1e-5)
    # content spread across the domain occupies MANY experts, not one border
    assert len(np.unique(np.asarray(vid_a))) > 8


def test_ngp_domain_equivalence():
    dom = (-2.75, -1.25)
    m_dom = NGPModel(num_levels=4, log2_table=10, max_res=64, domain=dom)
    m_ref = NGPModel(num_levels=4, log2_table=10, max_res=64)
    tables = m_dom.init(jax.random.key(0))["tables"]
    p = _pts()
    enc_a = m_dom.encode(tables, p)
    enc_b = m_ref.encode(tables, remap_domain(p, dom))
    np.testing.assert_allclose(np.asarray(enc_a), np.asarray(enc_b),
                               atol=1e-6)
    # points across the domain produce distinct encodings (not all clipped
    # onto one face, which is what the old [-1,1] assumption did); the
    # absolute scale is tiny because NGP tables init at U(-1e-4, 1e-4)
    a = np.asarray(enc_a)
    assert np.abs(a - a[0]).max() > 1e-6


def test_fastnerf_bake_covers_domain():
    dom = (-2.75, -1.25)
    model = FastNeRFModel(hidden_dim=16, num_factors=2, domain=dom,)
    params = model.init(jax.random.key(0))
    baked = model.bake(params, grid_res=9, dir_res=8)
    assert baked.domain == dom
    # baked == live exactly at lattice nodes of the DOMAIN cube
    lin = np.linspace(dom[0], dom[1], 9, dtype=np.float32)
    pts = jnp.asarray(np.stack(np.meshgrid(lin[:3], lin[4:6], lin[6:8],
                                           indexing="ij"),
                               axis=-1).reshape(-1, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), pts.shape)
    rgb_live, sig_live = model.apply(params, pts, d)
    rgb_bake, sig_bake = baked.apply(None, pts, d)
    np.testing.assert_allclose(np.asarray(sig_bake),
                               np.asarray(jax.nn.relu(sig_live)), atol=1e-3)
    np.testing.assert_allclose(np.asarray(rgb_bake), np.asarray(rgb_live),
                               atol=1e-3)


def test_plenoctree_bake_propagates_domain():
    dom = (-2.75, -1.25)
    model = PlenOctreeModel(hidden_dim=16, domain=dom)
    params = model.init(jax.random.key(0))
    baked_model, baked_params = model.bake(params, grid_res=8)
    assert baked_model.domain == dom
    # grid node [0,0,0] stores the field at the domain's low corner
    sigma, sh = model.sh_field(params, jnp.asarray([[dom[0]] * 3]))
    raw = np.log(np.expm1(np.clip(np.asarray(sigma), 1e-8, None)))
    np.testing.assert_allclose(
        np.asarray(baked_params["grid"][0, 0, 0, 0]), raw[0], atol=1e-4)


def test_fit_uses_scene_bounds_for_llff_domain(tmp_path):
    """Non-NDC LLFF scenes derive near/far from dataset bounds; fit() must
    rebind cfg before building the model so grid_domain places the voxel
    grid in the frame the renderer actually normalizes with (found in
    review: the domain used the config's blender defaults 2/6 while the
    renderer used the reconstruction's world bounds)."""
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.train.loop import fit
    from tests.synthetic import make_synthetic_llff_scene

    root = tmp_path / "llff"
    make_synthetic_llff_scene(str(root), h=16, w=20, num_images=6)
    cfg = Config(
        dataset_path=str(root), dataset_type="llff", llff_factor=1,
        ndc=False, model_type="plenoxels", grid_res=8, learning_rate=0.01,
        num_random_rays=64, num_samples=8,
        donate_state=False, log_interval=5, val_interval=100,
        save_interval=100, save_path=str(tmp_path / "m"),
        log_dir=str(tmp_path / "l"),
    )
    scene = load_scene(cfg)
    assert scene.far > 6.0 or scene.near < 2.0  # bounds differ from config
    state = fit(cfg, max_steps=10, enable_tensorboard=False)
    g = np.asarray(state.params["grid"][..., 0])
    # training touched interior cells, not just the border (the old-frame
    # failure mode puts all content in clamped border cells)
    init_raw = float(np.log(np.expm1(0.1)))
    touched = np.argwhere(np.abs(g - init_raw) > 1e-9)
    assert touched.size, "no grid cell trained at all"
    interior = ((touched > 0) & (touched < 7)).all(axis=1)
    assert interior.any(), "only border cells trained — wrong domain frame"


# ----------------------------------------------------- the end-to-end point


def test_scene_content_trains_interior_cells():
    """A training gradient at the normalized image of the WORLD ORIGIN must
    touch interior grid cells — with the old [-1,1] grid domain it piled
    onto the border voxel (the failure mode this change fixes)."""
    cfg = Config(model_type="plenoxels", grid_res=8)
    model = model_from_config(cfg)
    params = model.init(jax.random.key(0))
    p0 = normalize_positions(jnp.zeros((4, 1, 3)), cfg.near, cfg.far)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (4, 1, 3))

    def loss(prm):
        rgb, sigma = model.apply(prm, p0, d)
        return jnp.sum(rgb) + jnp.sum(sigma)

    g = np.asarray(jax.grad(loss)(params)["grid"][..., 0])
    touched = np.argwhere(g != 0.0)
    assert touched.size, "no gradient reached the grid at all"
    # the world origin sits at the domain's center -> stencil cells are
    # strictly interior (neither 0 nor r-1 on any axis)
    assert (touched > 0).all() and (touched < 7).all()
