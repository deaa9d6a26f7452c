"""Checkpoints (counterpart of ``rtvc_tpu/train/checkpoints.py``).

The port's trainers write one ``torch.save`` file holding ``{step,
model_type, state_dict, optimizer, extras}``; the state dict is in the
reference's layout, the one every module of this package loads.

:func:`read_model` reads a model out of any of the three files users hold,
told apart by their content and never by their suffix:

* the JAX package's ``.ckpt``: the magic ``RTVCTPU1``, then flax msgpack of
  ``{meta (JSON), params, opt_state, extras}``, read by the port's own
  decoder (``utils/flax_msgpack.py``) and mapped to the port's layout by
  ``bridge``;
* the reference's torch ``.pt``: ``{step, model_state, optimizer_state[,
  model_type]}``;
* the port's own trainer file, above.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.utils import flax_msgpack

MAGIC = b"RTVCTPU1"
KINDS = ("encoder", "synthesizer", "vocoder")
# buffers of the reference's modules that the port's have not: Tacotron's,
# ForwardTacotron's and WaveRNN's step counters, the decoder's reduction
# factor (read into ``r`` first) and BatchNorm's batch counters
_REFERENCE_ONLY = ("step", "decoder.r")
_REFERENCE_ONLY_SUFFIX = ".num_batches_tracked"


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


@dataclasses.dataclass
class ModelCheckpoint:
    """A model read by :func:`read_model`: its state dict in the port's
    layout (on the CPU), the step it was trained to, its model type, the
    reduction factor it was trained at (synthesizers; None when the file
    does not say) and its hyper-parameters as a dict (None when the file
    carries none, as a reference ``.pt`` does: the defaults apply)."""

    state_dict: Dict[str, torch.Tensor]
    step: int
    model_type: Optional[str]
    r: Optional[int]
    config: Optional[Dict[str, Any]]


def _restore_lists(tree: Any) -> Any:
    """Undo flax's list → {'0': .., '1': ..} conversion: a dict whose keys
    are exactly '0'..'n-1' becomes a list again."""
    if isinstance(tree, dict):
        restored = {k: _restore_lists(v) for k, v in tree.items()}
        keys = list(restored.keys())
        if keys and all(isinstance(k, str) and k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [restored[str(i)] for i in idx]
        return restored
    return tree


def _from_jax(payload: dict, kind: str) -> ModelCheckpoint:
    meta = json.loads(payload["meta"])
    params = _restore_lists(payload["params"])
    extras = _restore_lists(payload.get("extras")) or {}
    model_type = meta.get("model_type")
    # without running statistics only the parameters map, and the strict
    # load that follows names what is missing
    variables = {"params": params}
    if extras.get("batch_stats"):
        variables["batch_stats"] = extras["batch_stats"]
    if kind == "encoder":
        # the GE2E trainer saves {model, similarity}; a bare model tree
        # takes the similarity scale's initial values
        tree = params if set(params) == {"model", "similarity"} else variables
        state = bridge.speaker_encoder_state(tree)
    elif kind == "synthesizer":
        state = {"forward-tacotron": bridge.forward_tacotron_state,
                 "fast-pitch": bridge.fast_pitch_state}.get(model_type,
                                                            bridge.tacotron_state)(variables)
    else:
        state = bridge.wavernn_state(variables)
    r = extras.get("r")
    return ModelCheckpoint(dict(state), int(meta["step"]), model_type,
                           None if r is None else int(np.asarray(r)), meta.get("config"))


def read_model(path, kind: str) -> ModelCheckpoint:
    """Read the model of a checkpoint in any of the three formats (see the
    module docstring); ``kind`` ("encoder", "synthesizer" or "vocoder")
    says which mapping a JAX ``.ckpt`` takes to the port's layout. Tensors
    come to the CPU wherever they were saved; the caller moves them."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    path = Path(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) == MAGIC:
            return _from_jax(flax_msgpack.restore(f.read()), kind)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state" in ckpt:
        state = dict(ckpt["model_state"])
        r = state.get("decoder.r")
        state = {k: v for k, v in state.items()
                 if k not in _REFERENCE_ONLY and not k.endswith(_REFERENCE_ONLY_SUFFIX)}
        return ModelCheckpoint(state, int(ckpt.get("step", 0)), ckpt.get("model_type"),
                               None if r is None else int(r), None)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        extras = ckpt.get("extras") or {}
        r = extras.get("r")
        return ModelCheckpoint(dict(ckpt["state_dict"]), int(ckpt["step"]),
                               ckpt.get("model_type"), None if r is None else int(r),
                               extras.get("config"))
    raise ValueError(f"{path} is none of the checkpoint formats rtvc_tpu_torch reads: a JAX "
                     ".ckpt, a reference .pt or a file of the port's trainers")
