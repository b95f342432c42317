"""Typed configuration with drop-in compatibility for the reference format.

The reference (`/root/reference/nerf/utils.py:9-34`) parses a line-oriented
``key = value`` text file with ``#`` comments and leaves every value a string,
casting at use-site with per-key defaults (`/root/reference/train.py:40-76`).
Here the same file format feeds a typed dataclass: unknown keys warn (as the
reference warns on malformed lines), known keys are cast once, and defaults
match the reference's use-site defaults so a reference config file behaves
identically.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass


def parse_kv_file(path: str) -> dict[str, str]:
    """Parse ``key = value`` lines; ``#`` starts a comment (full-line or inline).

    Mirrors the reference parser's behavior (warn on lines without ``=``,
    strip whitespace, keep values as strings).
    """
    out: dict[str, str] = {}
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                print(f"Warning: Invalid line in config file: {line}", file=sys.stderr)
                continue
            key, value = line.split("=", maxsplit=1)
            out[key.strip()] = value.strip()
    return out


def _as_bool(s: str) -> bool:
    return str(s).strip().lower() in ("true", "1", "yes", "on")


@dataclass
class Config:
    """All knobs for training/eval. Defaults match the reference's use-site
    defaults (`/root/reference/train.py:40-76`, `eval.py:66-76`) so an
    unmodified reference config file trains the same schedule.
    """

    # --- dataset ---
    dataset_path: str = "./datasets/lego"
    dataset_type: str = "blender"  # "blender" | "llff"  (llff is an extension)
    white_background: bool = True  # reference hardcodes True (train.py:174)
    half_res: bool = False         # downsample images 2x at load time
    llff_factor: int = 8           # LLFF image downsample factor
    ndc: bool = True               # use NDC rays for llff forward-facing scenes

    # --- sampling ---
    num_random_rays: int = 1024
    chunk_size: int = 8192         # reference GPU-memory bound (train.py:44)
    eval_chunk_size: int = 0       # ray tile for full-image renders; 0 = auto
                                   # (train/loop.py::resolve_eval_chunk)
    num_samples: int = 256
    num_fine_samples: int = 0      # >0 enables hierarchical coarse/fine
    perturb: bool = True           # stratified jitter on/off (off => bin midpoints? no: lower edges + 0.5)
    jitter_mode: str = "per_ray"   # "per_ray" | "shared" (shared = reference semantics,
                                   # one t-vector for the whole batch, rendering.py:6-27)
    fine_sampling: str = "merge"   # "merge" (original-NeRF sorted union) |
                                   # "resample" (one stratified sorted
                                   # inverse-CDF draw — no merge op; see
                                   # RenderSettings.fine_sampling)

    # --- training ---
    num_iters: int = 150000
    learning_rate: float = 5e-4
    near: float = 2.0
    far: float = 6.0
    lr_decay: float = 150.0        # in units of 1000 steps
    lr_decay_factor: float = 0.1
    lr_min: float = 1e-5
    seed: int = 42
    tv_lambda: float = 0.0         # total-variation weight on the density
                                   # channel (grid families with a .tv hook,
                                   # i.e. plenoxels / baked-plenoctree
                                   # training; the Plenoxels paper's core
                                   # prior — try ~1e-3 on sparse views)
    tv_sh_lambda: float = 0.0      # TV weight on the SH/color channels
    upsample_steps: str = ""       # coarse-to-fine schedule for voxel-grid
                                   # families (the Plenoxels paper's
                                   # 128->256 recipe): "step:res,step:res",
                                   # e.g. "2000:64,5000:128" — at each step
                                   # the grid is trilinearly upsampled and
                                   # the optimizer moments restart
    distill_from: str = ""         # teacher checkpoint path: run KiloNeRF-
                                   # style field distillation (random
                                   # points/dirs over the scene volume,
                                   # student regresses teacher rgb/sigma)
                                   # before the photometric loop (fresh
                                   # runs only; see train/distill.py)
    distill_steps: int = 0         # field-matching steps before fine-tuning
    distill_batch: int = 16384     # points per distillation step
    occupancy_res: int = 0         # >0: occupancy-guided training (the
                                   # Instant-NGP-style accelerator with a
                                   # static sample count — ops/occupancy.py):
                                   # bake a res^3 occupancy prior from the live
                                   # field every occupancy_interval steps
                                   # and draw the coarse samples from its
                                   # inverse CDF. With the density-bias
                                   # init the first bake is all-occupied
                                   # (= uniform sampling) and tightens as
                                   # the field carves free space.
    occupancy_interval: int = 1000  # rebake cadence (steps)
    occupancy_thresh: float = 1e-2  # sigma threshold for "occupied"

    # --- checkpointing ---
    save_path: str = "./models"
    save_interval: int = 5000

    # --- monitoring ---
    log_interval: int = 10
    val_interval: int = 1000
    first_step_render: bool = False
    log_dir: str = "./logs"

    # --- model ---
    model_type: str = "nerf"       # "nerf" | "siren" | "gabor" | "kilonerf"
    hidden_dim: int = 256
    pos_encoding_dim: int = 10     # frequencies L for points
    dir_encoding_dim: int = 4      # frequencies L for directions
    separate_fine_model: bool = True  # independent fine params when hierarchical
    grid_res: int = 0              # grid-based families: kilonerf network
                                   # grid (default 8; pair with hidden_dim
                                   # 32) / plenoxels voxel grid (default
                                   # 128). 0 = model's own default.
    reference_init: bool = False   # strict parity: torch's raw Linear init,
                                   # no deterministic density-bias guard
                                   # (fresh-init distributions then match the
                                   # reference exactly — including its
                                   # dead-ReLU coin-flip)
    scene_bound: float = 1.5       # world-space half-extent of scene content
                                   # (grid families size their voxel domain to
                                   # the reference-normalized image of the
                                   # [-s, s]^3 world cube; see
                                   # models/registry.py::grid_domain. MLP
                                   # families ignore it). 1.5 covers the
                                   # standard Blender synthetic scenes.

    # --- eval ---
    num_render_poses: int = 40

    # --- performance (extensions; no reference counterpart) ---
    compute_dtype: str = "float32"   # "float32" | "bfloat16" matmul operand
                                     # dtype; float32 is full float32 (no TF32,
                                     # models/common.py::linear)
    steps_per_call: int = 0          # train steps per compiled dispatch (lax.scan);
                                     # 0 = auto (gcd of log/val/save intervals),
                                     # 1 = one dispatch per step (reference cadence)
    mesh_shape: str = ""             # e.g. "data:8"; empty = all devices on 'data'
    multihost: bool = False          # call jax.distributed.initialize() (env
                                     # auto-detection) so the mesh spans all hosts
    epoch_sampling: bool = False     # strict reference parity: epoch permutation
                                     # without replacement (DataLoader shuffle
                                     # semantics, train.py:119-121,155-160);
                                     # default = uniform with replacement
    donate_state: bool = True
    debug_nans: bool = False         # jax_debug_nans: fail fast on NaN/Inf
    profile_dir: str = ""            # capture a jax.profiler trace to this dir

    def __post_init__(self) -> None:
        self.model_type = self.model_type.lower()

    @property
    def lr_schedule_gamma(self) -> float:
        """Per-step decay: gamma = factor ** (1/(lr_decay*1000)) (train.py:126)."""
        return float(self.lr_decay_factor) ** (1.0 / (float(self.lr_decay) * 1000.0))


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def config_from_dict(d: dict[str, str], warn_unknown: bool = True) -> Config:
    kwargs = {}
    for key, value in d.items():
        f = _FIELDS.get(key)
        if f is None:
            if warn_unknown:
                print(f"Warning: Unknown config key: {key}", file=sys.stderr)
            continue
        if f.type in ("bool", bool):
            kwargs[key] = _as_bool(value)
        elif f.type in ("int", int):
            kwargs[key] = int(float(value))
        elif f.type in ("float", float):
            kwargs[key] = float(value)
        else:
            kwargs[key] = str(value)
    return Config(**kwargs)


def parse_config_file(path: str) -> Config:
    return config_from_dict(parse_kv_file(path))


def parse_config(path: str) -> dict[str, str]:
    """Reference-API shim: returns the raw string dict like
    `nerf/utils.py::parse_config` does."""
    return parse_kv_file(path)
