"""Model registry: name -> constructor, mirroring the reference's model
selection by lowercased ``model_type`` with an error on unknown types
(/root/reference/train.py:100-105)."""

from __future__ import annotations

from typing import Callable

from nerf_jax.models.fastnerf import FastNeRFModel
from nerf_jax.models.gabor import GaborModel
from nerf_jax.models.kilonerf import KiloNeRFModel
from nerf_jax.models.nerf import NeRFModel
from nerf_jax.models.ngp import NGPModel
from nerf_jax.models.plenoctree import PlenOctreeModel
from nerf_jax.models.plenoxels import PlenoxelsModel
from nerf_jax.models.siren import SirenModel

MODEL_REGISTRY: dict[str, Callable] = {
    "nerf": NeRFModel,
    "siren": SirenModel,
    "gabor": GaborModel,  # reference roadmap item (notes.txt:3); MFN-Gabor
    "kilonerf": KiloNeRFModel,  # reference roadmap item (notes.txt:4)
    "fastnerf": FastNeRFModel,  # reference roadmap item (notes.txt:5)
    "plenoctree": PlenOctreeModel,  # reference roadmap item (notes.txt:6)
    "ngp": NGPModel,  # reference roadmap item (notes.txt:7); Instant NGP
    "plenoxels": PlenoxelsModel,  # reference roadmap item (notes.txt:8)
}


def create_model(model_type: str, **kwargs):
    model_type = model_type.lower()
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f"Invalid model type: {model_type}")
    cls = MODEL_REGISTRY[model_type]
    # Only forward kwargs the model understands (configs carry shared knobs).
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in names})


def grid_domain(cfg) -> tuple[float, float]:
    """The cube (lo, hi) a grid-family model covers, in the MODEL'S INPUT
    space — i.e. after the reference's componentwise [near,far] -> [-1,1]
    position map (rendering.py:67-107), which the renderer applies to every
    field query.

    That map sends world xyz = near to -1 and far to +1; scene content near
    the world origin therefore lands around ``-2*near/(far-near) - 1``
    (≈ -2 at the default near=2/far=6), OUTSIDE [-1,1]^3. MLP families don't
    care (sin/cos encodings extrapolate), but a voxel/hash grid that assumes
    [-1,1]^3 would clip the whole scene onto its border cells. Grid models
    therefore carry this domain and remap internally; it is the normalized
    image of the world cube [-scene_bound, scene_bound]^3.

    NDC scenes skip the normalization (points are natively in [-1,1]^3).
    """
    if cfg.dataset_type == "llff" and cfg.ndc:
        return (-1.0, 1.0)
    s = float(cfg.scene_bound)
    lo = 2.0 * (-s - cfg.near) / (cfg.far - cfg.near) - 1.0
    hi = 2.0 * (s - cfg.near) / (cfg.far - cfg.near) - 1.0
    return (lo, hi)


def model_from_config(cfg) -> object:
    """Build a model from a `nerf_jax.config.Config`."""
    common = dict(
        hidden_dim=cfg.hidden_dim,
        pos_encoding_dim=cfg.pos_encoding_dim,
        dir_encoding_dim=cfg.dir_encoding_dim,
        compute_dtype=cfg.compute_dtype,
        reference_init=cfg.reference_init,
        # grid families only (create_model filters per-model):
        domain=grid_domain(cfg),
    )
    if cfg.grid_res > 0:  # grid families keep their own default otherwise
        common["grid_res"] = cfg.grid_res
    return create_model(cfg.model_type, **common)
