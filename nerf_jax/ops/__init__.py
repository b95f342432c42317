from nerf_jax.ops.sampling import (
    stratified_sample,
    sample_positions,
    sample_pdf,
    merge_samples,
    deltas_from_t,
)
from nerf_jax.ops.volume import (
    exclusive_cumprod,
    composite,
    CompositeOutput,
)
from nerf_jax.ops.ndc import ndc_rays

__all__ = [
    "stratified_sample",
    "sample_positions",
    "sample_pdf",
    "merge_samples",
    "deltas_from_t",
    "exclusive_cumprod",
    "composite",
    "CompositeOutput",
    "ndc_rays",
]
