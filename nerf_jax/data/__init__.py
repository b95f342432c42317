from nerf_jax.data.rays import compute_rays, compute_rays_single
from nerf_jax.data.blender import load_blender
from nerf_jax.data.llff import load_llff
from nerf_jax.data.pipeline import RayPool, build_ray_pool, load_scene

__all__ = [
    "compute_rays",
    "compute_rays_single",
    "load_blender",
    "load_llff",
    "RayPool",
    "build_ray_pool",
    "load_scene",
]


def load_dataset(dataset_path: str, mode: str = "train", single_image: bool = False):
    """Reference-API shim for `nerf/data.py::load_dataset` (Blender only)."""
    return load_blender(dataset_path, mode=mode, single_image=single_image)
