from nerf_jax.models.encoding import positional_encoding
from nerf_jax.models.nerf import NeRFModel
from nerf_jax.models.siren import SirenModel
from nerf_jax.models.gabor import GaborModel
from nerf_jax.models.kilonerf import KiloNeRFModel
from nerf_jax.models.fastnerf import FastNeRFModel
from nerf_jax.models.plenoxels import PlenoxelsModel
from nerf_jax.models.ngp import NGPModel
from nerf_jax.models.plenoctree import PlenOctreeModel
from nerf_jax.models.registry import create_model, MODEL_REGISTRY

__all__ = [
    "positional_encoding",
    "NeRFModel",
    "SirenModel",
    "GaborModel",
    "KiloNeRFModel",
    "FastNeRFModel",
    "PlenoxelsModel",
    "NGPModel",
    "PlenOctreeModel",
    "create_model",
    "MODEL_REGISTRY",
]
