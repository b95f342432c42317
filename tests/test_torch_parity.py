"""Cross-framework allclose tests (SURVEY.md §4 item 2): port nerf_jax
weights into torch modules built to the reference architecture spec
(models.py:9-75, 130-203; rendering.py:125-153) and compare rendered values
and gradients on fixed inputs. Torch runs on CPU in float64-free fp32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from nerf_jax.models import NeRFModel, SirenModel
from nerf_jax.ops.sampling import deltas_from_t
from nerf_jax.ops.volume import composite


def _torch_nerf_forward(params, points, dirs):
    """Reference NeRF forward in torch from a nerf_jax pytree (weights are
    (in,out) in JAX convention -> use x @ w directly)."""
    t = lambda a: torch.from_numpy(np.asarray(a))
    x = torch.from_numpy(points)
    d = torch.from_numpy(dirs)

    def enc(v, L):
        out = [v]
        for j in range(L):
            out += [torch.sin(2.0**j * v), torch.cos(2.0**j * v)]
        return torch.cat(out, dim=1)

    pe, de = enc(x, 10), enc(d, 4)
    h = pe
    for lyr in params["block1"]:
        h = torch.relu(h @ t(lyr["w"]) + t(lyr["b"]))
    h = torch.cat([h, pe], dim=1)
    for lyr in params["block2"][:-1]:
        h = torch.relu(h @ t(lyr["w"]) + t(lyr["b"]))
    h = h @ t(params["block2"][-1]["w"]) + t(params["block2"][-1]["b"])
    sigma = torch.relu(h[:, -1])
    feat = h[:, :-1]
    y = torch.relu(
        torch.cat([feat, de], dim=1) @ t(params["rgb"][0]["w"])
        + t(params["rgb"][0]["b"])
    )
    rgb = torch.sigmoid(y @ t(params["rgb"][1]["w"]) + t(params["rgb"][1]["b"]))
    return rgb, sigma


def test_nerf_forward_matches_torch():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    rgb_j, sig_j = model.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    rgb_t, sig_t = _torch_nerf_forward(params, pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb_j), rgb_t.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.asarray(sig_j), sig_t.numpy(), atol=2e-4)


def test_rendered_pixels_and_param_grads_match_torch():
    """Full pipeline parity on fixed t-samples: composite(model(points)) and
    d loss / d params agree between JAX and torch autograd."""
    model = NeRFModel(hidden_dim=256)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    R, S = 8, 16
    rays_o = rng.normal(scale=0.1, size=(R, 3)).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    near, far = 2.0, 6.0
    t_np = np.linspace(near, far, S, dtype=np.float32)
    t_np = np.broadcast_to(t_np, (R, S)).copy()
    target = rng.uniform(size=(R, 3)).astype(np.float32)

    # --- JAX side ---
    def jax_loss(p):
        t = jnp.asarray(t_np)
        pts = jnp.asarray(rays_o)[:, None] + t[..., None] * jnp.asarray(rays_d)[:, None]
        ptsn = 2 * (pts - near) / (far - near) - 1
        dirs = jnp.broadcast_to(jnp.asarray(rays_d)[:, None], pts.shape)
        rgb, sigma = model.apply(p, ptsn.reshape(-1, 3), dirs.reshape(-1, 3))
        out = composite(
            rgb.reshape(R, S, 3), sigma.reshape(R, S), deltas_from_t(t),
            white_background=True,
        )
        return jnp.mean((out.rgb - jnp.asarray(target)) ** 2)

    loss_j, grads_j = jax.value_and_grad(jax_loss)(params)

    # --- torch side (same math, reference formulation) ---
    tp = jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), params
    )

    def torch_t(a):
        return a  # already torch

    t = torch.from_numpy(t_np)
    pts = torch.from_numpy(rays_o)[:, None] + t[..., None] * torch.from_numpy(rays_d)[:, None]
    ptsn = 2 * (pts - near) / (far - near) - 1
    dirs = torch.from_numpy(rays_d)[:, None].expand(R, S, 3)

    def enc(v, L):
        out = [v]
        for j in range(L):
            out += [torch.sin(2.0**j * v), torch.cos(2.0**j * v)]
        return torch.cat(out, dim=1)

    pe = enc(ptsn.reshape(-1, 3), 10)
    de = enc(dirs.reshape(-1, 3), 4)
    h = pe
    for lyr in tp["block1"]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
    h = torch.cat([h, pe], dim=1)
    for lyr in tp["block2"][:-1]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
    h = h @ tp["block2"][-1]["w"] + tp["block2"][-1]["b"]
    sigma = torch.relu(h[:, -1]).reshape(R, S)
    feat = h[:, :-1]
    y = torch.relu(torch.cat([feat, de], dim=1) @ tp["rgb"][0]["w"] + tp["rgb"][0]["b"])
    rgb = torch.sigmoid(y @ tp["rgb"][1]["w"] + tp["rgb"][1]["b"]).reshape(R, S, 3)

    deltas = torch.cat([t[:, 1:] - t[:, :-1], torch.full((R, 1), 1e10)], dim=1)
    alpha = 1 - torch.exp(-sigma * deltas)
    betas = 1 - alpha
    accum = torch.cumprod(betas, dim=1)
    trans = torch.cat([torch.ones(R, 1), accum[:, :-1]], dim=1)
    weights = trans * alpha
    comp = (weights[..., None] * rgb).sum(dim=1)
    comp = comp + (1 - weights.sum(dim=1, keepdim=True))
    loss_t = torch.mean((comp - torch.from_numpy(target)) ** 2)
    loss_t.backward()

    np.testing.assert_allclose(float(loss_j), float(loss_t), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(grads_j), jax.tree_util.tree_leaves(tp)
    ):
        scale = np.abs(np.asarray(a)).max() + 1e-10
        np.testing.assert_allclose(
            np.asarray(a) / scale, b.grad.numpy() / scale, atol=5e-4
        )


def test_siren_forward_matches_torch():
    model = SirenModel()
    params = model.init(jax.random.key(2))
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, size=(32, 3)).astype(np.float32)
    dirs = rng.normal(size=(32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    t = lambda a: torch.from_numpy(np.asarray(a))
    x = torch.from_numpy(pts)
    w0s = [model.w0] + [model.hidden_w0] * (model.num_layers - 1)
    for lyr, w0 in zip(params["base"], w0s):
        x = torch.sin(w0 * (x @ t(lyr["w"]) + t(lyr["b"])))
    sig_t = torch.relu(x @ t(params["sigma"]["w"]) + t(params["sigma"]["b"]))
    sig_t = (sig_t * model.sigma_mul)[:, 0]
    feat = x @ t(params["remap"]["w"]) + t(params["remap"]["b"])

    def enc(v, L):
        out = [v]
        for j in range(L):
            out += [torch.sin(2.0**j * v), torch.cos(2.0**j * v)]
        return torch.cat(out, dim=1)

    de = enc(torch.from_numpy(dirs), 4)
    y = torch.sin(
        model.hidden_w0
        * (torch.cat([feat, de], dim=1) @ t(params["rgb0"]["w"]) + t(params["rgb0"]["b"]))
    )
    rgb_t = torch.sigmoid(
        (y @ t(params["rgb1"]["w"]) + t(params["rgb1"]["b"])) * model.rgb_mul
    )

    rgb_j, sig_j = model.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(rgb_j), rgb_t.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.asarray(sig_j), sig_t.numpy(), atol=2e-4)


def test_fused_train_kernel_matches_torch_end_to_end():
    """The train pass as the trainer runs it — the renderer's own
    sampling, position normalization and compositing (render_rays) under
    MSE — reproduces the reference-formulated torch loss and parameter
    gradients on fixed t-samples (deterministic midpoints -> both sides
    sample identically)."""
    from nerf_jax.render.renderer import RenderSettings, render_rays

    model = NeRFModel(hidden_dim=256)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    R, S = 8, 16
    rays_o = rng.normal(scale=0.1, size=(R, 3)).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    near, far = 2.0, 6.0
    target = rng.uniform(size=(R, 3)).astype(np.float32)

    # perturb=False -> t at bin centers, identical on both sides
    edges = np.linspace(near, far, S + 1, dtype=np.float32)
    t_np = np.broadcast_to(0.5 * (edges[:-1] + edges[1:]), (R, S)).copy()

    # --- the plain train pass ---
    settings = RenderSettings(near=near, far=far, num_samples=S,
                              white_background=True, perturb=False)

    def loss_plain(p):
        out = render_rays(model.apply, p, jnp.asarray(rays_o),
                          jnp.asarray(rays_d), jax.random.key(0), settings)
        return jnp.mean((out.rgb - jnp.asarray(target)) ** 2)

    loss_j, grads_j = jax.value_and_grad(loss_plain)(params)

    # --- torch side (reference formulation) ---
    tp = jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), params
    )
    t = torch.from_numpy(t_np)
    pts = torch.from_numpy(rays_o)[:, None] + t[..., None] * torch.from_numpy(rays_d)[:, None]
    ptsn = 2 * (pts - near) / (far - near) - 1
    dirs = torch.from_numpy(rays_d)[:, None].expand(R, S, 3)

    def enc(v, L):
        out = [v]
        for j in range(L):
            out += [torch.sin(2.0**j * v), torch.cos(2.0**j * v)]
        return torch.cat(out, dim=1)

    pe = enc(ptsn.reshape(-1, 3), 10)
    de = enc(dirs.reshape(-1, 3), 4)
    h = pe
    for lyr in tp["block1"]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
    h = torch.cat([h, pe], dim=1)
    for lyr in tp["block2"][:-1]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
    h = h @ tp["block2"][-1]["w"] + tp["block2"][-1]["b"]
    sigma = torch.relu(h[:, -1]).reshape(R, S)
    feat = h[:, :-1]
    y = torch.relu(torch.cat([feat, de], dim=1) @ tp["rgb"][0]["w"] + tp["rgb"][0]["b"])
    rgb = torch.sigmoid(y @ tp["rgb"][1]["w"] + tp["rgb"][1]["b"]).reshape(R, S, 3)

    deltas = torch.cat([t[:, 1:] - t[:, :-1], torch.full((R, 1), 1e10)], dim=1)
    alpha = 1 - torch.exp(-sigma * deltas)
    accum = torch.cumprod(1 - alpha, dim=1)
    trans = torch.cat([torch.ones(R, 1), accum[:, :-1]], dim=1)
    weights = trans * alpha
    comp = (weights[..., None] * rgb).sum(dim=1)
    comp = comp + (1 - weights.sum(dim=1, keepdim=True))
    loss_t = torch.mean((comp - torch.from_numpy(target)) ** 2)
    loss_t.backward()

    np.testing.assert_allclose(float(loss_j), float(loss_t.detach()), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(grads_j), jax.tree_util.tree_leaves(tp)
    ):
        bg = b.grad.numpy()
        scale = np.abs(bg).max() + 1e-10
        np.testing.assert_allclose(
            np.asarray(a) / scale, bg / scale, atol=2e-3
        )
