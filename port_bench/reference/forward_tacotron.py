"""Plain ForwardTacotron (generate, eval mode): three series predictors
(embedding ‖ speaker → three BatchNorm convs of kernel 5 → BiGRU → linear)
over the characters; durations rounded as the fork rounds them; the trunk
embedding → CBHG pre-net (the forward variant: BiGRU as wide as its
channels, a pre-highway projection) → + the pitch and energy projections →
length regulator → ‖ speaker → BiLSTM over each row's own length → linear →
the CBHG postnet over each row's own length → projection.

``W`` is a flat dict under the published state-dict names
(``params.forward_tacotron_spec``); ``c`` a configuration's
``forward_tacotron`` block.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from port_bench.reference.nn import (
    Prec,
    Weights,
    batch_norm_eval,
    bigru,
    cbhg,
    conv_seq,
    lstm_seq,
    reverse_valid,
)

Tensor = torch.Tensor

PADDING_VALUE = -11.5129  # log(1e-5), the fork's mel floor


def predictor(P: Prec, W: Weights, p: str, chars: Tensor, spk: Tensor) -> Tensor:
    """→ (B, T) predictions."""
    h = W[p + "embedding.weight"][chars.long()]
    h = torch.cat([h, spk[:, None, :].expand(-1, h.shape[1], -1)], dim=2)
    for i in range(3):
        q = f"{p}convs.{i}."
        h = batch_norm_eval(W, q + "bnorm.", torch.relu(conv_seq(P, W, q + "conv.", h, 2,
                                                                  bias=False)))
    h = bigru(P, W, p + "rnn.", h)
    return P.linear(h, W[p + "lin.weight"], W[p + "lin.bias"])[..., 0]


def round_durations(dur: np.ndarray) -> np.ndarray:
    """If the truncated predictions sum to ≤ 0 over the batch every duration
    becomes 2; then floor(d + 0.5), negatives to 0."""
    if np.trunc(dur).sum() <= 0:
        dur = np.full_like(dur, 2.0)
    return np.maximum(np.floor(dur + 0.5), 0.0).astype(np.int64)


def bilstm(P: Prec, W: Weights, x: Tensor, lens: Tensor) -> Tensor:
    """Packed-sequence BiLSTM on (B, T, I): the backward direction reads each
    row reversed by its own length; positions at or past it take the
    padding value."""
    mask = (torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None])[..., None]
    fwd = lstm_seq(P, W, "lstm.", "", x)
    x_rev = torch.where(mask, reverse_valid(x, lens), 0.0)
    bwd = reverse_valid(lstm_seq(P, W, "lstm.", "_reverse", x_rev), lens)
    return torch.where(mask, torch.cat([fwd, bwd], dim=-1), PADDING_VALUE)


@torch.no_grad()
def generate(P: Prec, W: Weights, c: dict, chars: Tensor, spk: Tensor
             ) -> Tuple[Tensor, np.ndarray]:
    """chars (B, T) and speaker embeddings (B, S) → (postnet mels (B, n_mels,
    max length), integer durations (B, T))."""
    dur = predictor(P, W, "dur_pred.", chars, spk)
    pitch = predictor(P, W, "pitch_pred.", chars, spk)[..., None]
    energy = predictor(P, W, "energy_pred.", chars, spk)[..., None]
    durations = round_durations(dur.double().cpu().numpy())
    lens_np = durations.sum(axis=1)
    L = max(int(lens_np.max()), 1)
    lens = torch.as_tensor(lens_np, device=chars.device)
    h = cbhg(P, W, "prenet.", W["embedding.weight"][chars.long()], c["prenet_k"],
             c["prenet_num_highways"])
    h = h + conv_seq(P, W, "pitch_proj.", pitch, 1) * c["pitch_strength"]
    h = h + conv_seq(P, W, "energy_proj.", energy, 1) * c["energy_strength"]
    cum = torch.as_tensor(durations, device=chars.device).cumsum(1)
    pos = torch.arange(L, device=chars.device).expand(chars.shape[0], -1).contiguous()
    idx = torch.searchsorted(cum, pos, right=True).clamp(max=chars.shape[1] - 1)
    h = h.gather(1, idx[..., None].expand(-1, -1, h.shape[2]))
    h = torch.cat([h, spk[:, None, :].expand(-1, L, -1)], dim=2)
    h = bilstm(P, W, h, lens)
    mel = P.linear(h, W["lin.weight"], W["lin.bias"])
    post = cbhg(P, W, "postnet.", mel, c["postnet_k"], c["postnet_num_highways"], lengths=lens)
    return P.linear(post, W["post_proj.weight"]).transpose(1, 2), durations
