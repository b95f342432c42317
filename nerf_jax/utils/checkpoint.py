"""Checkpoint save/restore as ``.npz`` plus a JSON metadata sidecar.

Behavioral parity with the reference (/root/reference/nerf/utils.py:50-63,
train.py:143-149): a checkpoint stores ``{step, model_type, params,
opt_state}`` under ``{save_path}/{model_type}_model_{step:06d}``; the
``model_type`` is self-describing and takes precedence over config on resume
(train.py:67-69), and resume restores the optimizer state and step. The LR
schedule is a pure function of step, so the reference's "scheduler state" is
just the step counter.

Layout: the checkpoint is a directory holding ``state.npz`` (one array per
pytree leaf, keyed by its tree path), with ``<dir>.meta.json`` beside it.
The directory is written under a temporary name and renamed into place, so
a checkpoint directory that exists is complete.

Multi-host: arrays that span processes are gathered collectively (every
process calls save), and only process 0 writes. Restore reads the file on
every process and places each leaf onto the template's sharding.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import jax

_CKPT_RE = re.compile(r"^(?P<model>[a-z0-9_]+)_model_(?P<step>\d{6,})$")
_STATE_FILE = "state.npz"


def _state_dir(save_path: str, model_type: str, step: int) -> str:
    return os.path.join(os.path.abspath(save_path), f"{model_type}_model_{step:06d}")


def _to_host(x) -> np.ndarray:
    """One leaf -> a full host copy (collective for cross-process arrays)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        if x.is_fully_replicated:
            return np.asarray(x.addressable_data(0))
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


def _host_leaves(state: Any) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(path): _to_host(x) for path, x in flat}


def _write(path: str, arrays: dict[str, np.ndarray], model_type: str,
           step: int, extra: dict | None) -> None:
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _STATE_FILE), **arrays)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    meta = {"step": int(step), "model_type": model_type}
    if extra:
        meta.update(extra)  # e.g. grid_res after a coarse-to-fine upsample
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def save_checkpoint(
    state: Any, save_path: str, model_type: str, step: int,
    extra: dict | None = None,
) -> str:
    """Save a train-state pytree; returns the checkpoint directory."""
    path = _state_dir(save_path, model_type, step)
    arrays = _host_leaves(state)
    if jax.process_index() == 0:
        _write(path, arrays, model_type, step, extra)
    return path


def read_metadata(path: str) -> dict:
    path = os.path.abspath(path)
    # the metadata is written after the directory is renamed into place;
    # a meta file without its directory is not a checkpoint
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    meta = path + ".meta.json"
    if not os.path.exists(meta):
        raise FileNotFoundError(f"no checkpoint metadata for {path}")
    with open(meta, "r") as f:
        return json.load(f)


class AsyncCheckpointSaver:
    """Background checkpointing: ``save`` copies the state to the host
    (the only part that waits on the device) and hands the file write to
    a background thread while training continues (the reference blocks the
    loop on ``torch.save``, utils.py:50-63). Saves commit in order. Call
    ``wait`` before relying on a checkpoint being on disk.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []

    def save(self, state: Any, save_path: str, model_type: str, step: int,
             extra: dict | None = None) -> str:
        path = _state_dir(save_path, model_type, step)
        arrays = _host_leaves(state)
        if jax.process_index() == 0:
            self._pending.append(self._pool.submit(
                _write, path, arrays, model_type, step, extra))
        return path

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()  # re-raises a failed write

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a pytree saved by ``save_checkpoint``. ``template`` is a
    pytree of arrays or ShapeDtypeStructs with the target structure; each
    restored leaf lands on the template leaf's sharding when it has one."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(os.path.join(os.path.abspath(path), _STATE_FILE)) as data:
        leaves = []
        for key_path, tmpl in flat:
            name = jax.tree_util.keystr(key_path)
            if name not in data:
                raise KeyError(f"checkpoint {path} has no leaf {name}")
            arr = data[name]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint leaf {name}: shape {arr.shape}, expected "
                    f"{tuple(tmpl.shape)}")
            arr = arr.astype(tmpl.dtype)
            sharding = getattr(tmpl, "sharding", None)
            leaves.append(jax.device_put(arr, sharding) if sharding is not None
                          else jax.device_put(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def latest_checkpoint(save_path: str, model_type: Optional[str] = None) -> Optional[str]:
    """Most recent checkpoint dir under ``save_path`` (optionally filtered by
    model type), or None."""
    save_path = os.path.abspath(save_path)
    if not os.path.isdir(save_path):
        return None
    best: tuple[int, str] | None = None
    for name in os.listdir(save_path):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        if model_type is not None and m.group("model") != model_type:
            continue
        step = int(m.group("step"))
        if best is None or step > best[0]:
            best = (step, name)
    return os.path.join(save_path, best[1]) if best else None
