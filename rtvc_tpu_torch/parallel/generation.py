"""WaveRNN generation with its folds split over several devices
(counterpart of ``rtvc_tpu/parallel/generation.py``).

The JAX function shards the fold axis over a mesh and runs one jitted
program. Here one process drives a list of devices: the folds are cut into
one contiguous shard a device, and K1 (``ops/wavernn_generate.py``) is
launched once a shard, on its device's current stream, against a replica of
the model there. Launches on distinct devices run at the same time; two
shards on one device run one after the other on its stream (K1 is a
cooperative launch that holds the whole card). Nothing passes between the
devices until the samples are gathered.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Sequence

import torch
import torch.nn.functional as F

from rtvc_tpu_torch.models.wavernn import (
    WaveRNN,
    WaveRNNDims,
    fold_with_overlap,
    generate_core,
    upsample_forward,
    xfade_and_unfold,
)

Tensor = torch.Tensor


@torch.no_grad()
def generate_sharded(model: WaveRNN, d: WaveRNNDims, mels, seed: int, devices: Sequence,
                     target: int = 6000, overlap: int = 1000, argmax: bool = False,
                     compute_dtype=None, stream_dtype=None) -> Tensor:
    """Batched generation with the folds split over ``devices`` (a list of
    torch devices, one may repeat). ``mels`` (n_mels, n) or (1, n_mels, n)
    are padded, upsampled and folded on the model's device; the folds are
    padded with zeros to a multiple of the device count, cut into equal
    contiguous shards, one a device, each generated there by one K1 launch
    (``generate_core``: ``argmax``, ``compute_dtype``, ``stream_dtype``;
    shard i at seed ``seed + i``), then gathered on the model's device, cut
    to the real folds and unfolded. Returns the raw unfolded samples (before
    mu-law and de-emphasis), as the JAX function does. ``mels`` may be a
    numpy array or a tensor on any device. The model serves its own device;
    each other device gets one copy a call."""
    home = model.I.weight.device
    devices = [torch.device(dev) for dev in devices]
    replicas = {home: model}
    for dev in devices:
        if dev not in replicas:
            replicas[dev] = copy.deepcopy(model).to(dev)
    mels = torch.as_tensor(mels, dtype=torch.float32, device=home)
    if mels.ndim == 2:
        mels = mels[None]
    mels_up, aux, _ = upsample_forward(model, d, F.pad(mels, (d.pad, d.pad)))
    mels_up, n_folds = fold_with_overlap(mels_up, target, overlap)
    aux, _ = fold_with_overlap(aux, target, overlap)
    per = -(-n_folds // len(devices))
    extra = per * len(devices) - n_folds
    mels_up = F.pad(mels_up, (0, 0, 0, 0, 0, extra))
    aux = F.pad(aux, (0, 0, 0, 0, 0, extra))
    shards = []
    for i, dev in enumerate(devices):
        # ``seed`` for the first shard, so one device draws what
        # ``generate_core`` draws; the others vary in the low 32 bits, which
        # the plain version's generator reads
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            shards.append(generate_core(replicas[dev], d,
                                        mels_up[i * per:(i + 1) * per].to(dev),
                                        aux[i * per:(i + 1) * per].to(dev), seed + i, argmax,
                                        compute_dtype, stream_dtype))
    samples = torch.cat([s.to(home) for s in shards])[:n_folds]
    return xfade_and_unfold(samples, target, overlap)
