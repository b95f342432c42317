"""nerf_jax — a NeRF training and rendering framework in JAX.

Built from scratch in JAX/XLA with the full capabilities of the
PyTorch reference (`josedelrey/nerf-pytorch`, mounted at /root/reference):
Blender-synthetic and LLFF data loading, batched ray generation, stratified
and hierarchical (coarse/fine) sampling, positional and SIREN encodings, the
classic NeRF MLP with view-direction branch, alpha-compositing volume
integration, a full trainer (Adam + exponential LR decay with floor,
checkpoint/resume, TensorBoard metrics, validation renders) and a
spherical-orbit evaluation renderer.

Architecture, not a port:
  * the compute path is functional JAX (pytree params, jit, vmap, lax.map)
    that XLA compiles for the device — one compiled program per train step,
  * scale-out is a `jax.sharding.Mesh` with rays sharded over the `data` axis
    and parameters replicated; XLA emits the gradient psum
    (`nerf_jax.parallel`).
"""

from nerf_jax.version import __version__

from nerf_jax.config import Config, parse_config_file, config_from_dict
from nerf_jax.models import (
    NeRFModel,
    SirenModel,
    create_model,
    positional_encoding,
)
from nerf_jax.render import RenderSettings, render_rays, render_image
from nerf_jax.ops import (
    stratified_sample,
    sample_pdf,
    composite,
    exclusive_cumprod,
)
from nerf_jax.data import load_blender, compute_rays, RayPool

__all__ = [
    "__version__",
    "Config",
    "parse_config_file",
    "config_from_dict",
    "NeRFModel",
    "SirenModel",
    "create_model",
    "positional_encoding",
    "RenderSettings",
    "render_rays",
    "render_image",
    "stratified_sample",
    "sample_pdf",
    "composite",
    "exclusive_cumprod",
    "load_blender",
    "compute_rays",
    "RayPool",
]
