"""Structured group-of-4 magnitude pruning for the WaveRNN variants
(counterpart of ``rtvc_tpu/train/pruning.py``).

Sparsity follows the cubic ramp ``z = Z·(1 − (1 − (t − t₀)/S)³)``; each
pruned matrix keeps or zeroes whole groups of ``sparse_group`` columns, with
an independent threshold per gate section of a GRU matrix. The arithmetic
is f32, as in the JAX package, so both pick the same number of groups.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from rtvc_tpu_torch.models.wavernn import LAYERS, WaveRNN, WaveRNNDims

Tensor = torch.Tensor


def cubic_sparsity(step: int, start_prune: int, prune_steps: int, target: float) -> Tensor:
    """The sparsity level at ``step``, as an f32 scalar."""
    u = 1.0 - torch.tensor(step - start_prune, dtype=torch.int32) / prune_steps
    z = target * (1.0 - u * u * u)
    return torch.clamp(z, 0.0, target)


def group_prune_mask(W: Tensor, z: Tensor, sparse_group: int, splits: int) -> Tensor:
    """Keep-mask (0/1, W's dtype) for a (rows, cols) matrix: in each of
    ``splits`` row sections, the ⌊n·z⌋ column groups of least L1 norm are
    zeroed (groups below the k-th smallest norm)."""
    rows, cols = W.shape
    G = cols // sparse_group
    sec = rows // splits
    S = W.abs().reshape(splits, sec, G, sparse_group).sum(dim=3)
    k = (z * (sec * G)).to(torch.int32).clamp(0, sec * G - 1)
    thresh = torch.sort(S.reshape(splits, sec * G), dim=1).values[:, int(k)]
    mask = (S >= thresh[:, None, None]).to(W.dtype)
    return mask.repeat_interleave(sparse_group, dim=2).reshape(rows, cols)


def prunable_weights(d: WaveRNNDims) -> List[Tuple[str, int]]:
    """(state-dict name, gate splits) of every pruned matrix: the input
    layer, the variant's FCs, and both matrices of each of its GRUs."""
    layers = LAYERS[d.variant]
    out = [(f"{name}.weight", 1) for name in ("I", *(fc.name for fc in layers.fcs))]
    for rnn in layers.rnns:
        out += [(f"{rnn.name}.weight_ih_l0", 3), (f"{rnn.name}.weight_hh_l0", 3)]
    return out


@torch.no_grad()
def compute_prune_masks(model: WaveRNN, d: WaveRNNDims, step: int, start_prune: int,
                        prune_steps: int, sparsity_target: float,
                        sparsity_target_rnn: float, sparse_group: int) -> Dict[str, Tensor]:
    """Masks for every prunable matrix at training step ``step``, keyed by
    state-dict name."""
    params = dict(model.named_parameters())
    masks = {}
    for name, splits in prunable_weights(d):
        target = sparsity_target_rnn if splits > 1 else sparsity_target
        z = cubic_sparsity(step, start_prune, prune_steps, target)
        W = params[name]
        # a matrix whose columns do not split into groups is pruned by columns
        group = sparse_group if W.shape[1] % sparse_group == 0 else 1
        masks[name] = group_prune_mask(W, z.to(W.device), group, splits)
    return masks


@torch.no_grad()
def apply_prune_masks(model: WaveRNN, masks: Dict[str, Tensor]) -> None:
    """Zero the pruned weights in place."""
    params = dict(model.named_parameters())
    for name, mask in masks.items():
        params[name].mul_(mask)


def count_pruned(masks: Dict[str, Tensor]) -> Tuple[int, int]:
    """(number of zeroed weights, number of prunable weights)."""
    pruned = sum(int((m == 0).sum()) for m in masks.values())
    return pruned, sum(m.numel() for m in masks.values())
