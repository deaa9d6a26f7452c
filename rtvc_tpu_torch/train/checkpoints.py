"""Training checkpoints (counterpart of ``rtvc_tpu/train/checkpoints.py``).

A checkpoint is one ``torch.save`` file holding ``{step, model_type,
state_dict, optimizer, extras}``. The state dict is in the reference's
layout, the one every module of this package loads, so the inference
modules' ``load_state`` reads its ``state_dict`` as it is. Reading the JAX
package's ``.ckpt`` files (flax msgpack) is a later slice.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch import nn


def save_checkpoint(path, model: nn.Module, step: int, model_type: Optional[str] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    extras: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint atomically (a temporary file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": int(step),
        "model_type": model_type,
        "state_dict": model.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "extras": dict(extras or {}),
    }
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def load_checkpoint(path, map_location="cpu") -> Dict[str, Any]:
    """Read a checkpoint written by :func:`save_checkpoint` (tensors and
    plain containers only: ``weights_only`` loading runs no code from the
    file)."""
    return torch.load(Path(path), map_location=map_location, weights_only=True)


def backup_checkpoint(path, backup_dir, step: int) -> Path:
    """An immutable copy of the checkpoint, named by its step."""
    path, backup_dir = Path(path), Path(backup_dir)
    backup_dir.mkdir(parents=True, exist_ok=True)
    dest = backup_dir / f"{path.stem}_{step:09d}{path.suffix}"
    shutil.copyfile(path, dest)
    return dest
