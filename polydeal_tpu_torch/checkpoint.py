"""Checkpoint / resume of solver state, without orbax.

Counterpart of ``polydeal_tpu/checkpoint.py`` with the same layout: each
checkpoint is the directory ``<directory>/step_<k:08d>``.  It holds the
state, a flat dict of numpy arrays or tensors (solution history, gating
variables), as one ``state.npz`` written by ``np.savez``: dtypes and bits
are kept, so a resumed run matches the uninterrupted one bitwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_STATE = "state.npz"


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Save ``state`` under directory/step_<k>; returns the path.  An
    existing checkpoint of that step is replaced."""
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "state.tmp.npz")
    np.savez(tmp, **{k: _host(v) for k, v in state.items()})
    os.replace(tmp, os.path.join(path, _STATE))  # never half written
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_")
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """Restore (step, state) with the state as numpy arrays; step=None
    restores the latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}",
                        _STATE)
    with np.load(path) as f:
        return step, {k: f[k] for k in f.files}
