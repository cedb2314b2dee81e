"""Step-tagged training checkpoints (the port's counterpart of
``ecseg_tpu/runtime/checkpoint.py``).

A checkpoint is ``<ckpt_dir>/step_%08d.pt``: ``torch.save`` of the model's
and the optimizer's ``state_dict`` and the step.  It is written to a
temporary file, flushed to disk and renamed into place, so a crash never
leaves a partial file under a checkpoint's name and the last good one
stays; saving a step again overwrites it.  Orbax is JAX-only: the port
neither reads nor writes the JAX package's checkpoints (the exported
``metaseg.npz`` is what the two packages share).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"step_\d{8}\.pt$")


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> str:
    """Write the checkpoint of ``step``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": step}
    try:
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint with the highest step in ``ckpt_dir`` (temporary files
    ignored), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = [e for e in os.listdir(ckpt_dir) if _NAME.match(e)]
    return os.path.join(ckpt_dir, max(names)) if names else None


def restore_checkpoint(
    path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer, map_location="cpu"
) -> int:
    """Load a checkpoint into ``model`` and ``optimizer`` (which move its
    tensors to their own devices); returns its step."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
