"""K2: the Tacotron inference decoder loop.

``tacotron_decode`` launches the CUDA kernel in ``csrc/tacotron_decode.cu``
for CUDA tensors and runs ``tacotron_decode_plain`` (a Python loop of
``models.tacotron.decoder_step``) for CPU tensors. It replaces
``rtvc_tpu/ops/pallas/tacotron_kernel.py:decode_pallas``.

Both take the ``encode()`` outputs and return (mel (B, n_mels, max_iters·r),
attn (B, max_iters, T), stops (B, max_iters)), zero past the iteration where
every stop token fired. Prenet dropout stays on unless ``dropout=False``;
its noise comes from ``seed`` (Philox-4x32-10 in the kernel, a
``torch.Generator`` in the plain version), so the two agree exactly only
with dropout off.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.models.tacotron import Tacotron, TacotronDims, decode_loop

Tensor = torch.Tensor


def tacotron_decode_plain(model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                          encoder_seq_proj: Tensor, char_mask: Tensor, seed: int,
                          r: int, max_steps: int, dropout: bool = True
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    g = torch.Generator(device=encoder_seq.device).manual_seed(seed)
    return decode_loop(model, d, encoder_seq, encoder_seq_proj, char_mask, r,
                       max_steps, g, prenet_dropout=dropout)


def decoder_weights(model: Tacotron):
    """The decoder's weights in the kernel's order (torch layout)."""
    dec = model.decoder
    lsa = dec.attn_net
    ws = [
        dec.prenet.fc1.weight, dec.prenet.fc1.bias,
        dec.prenet.fc2.weight, dec.prenet.fc2.bias,
        dec.attn_rnn.weight_ih, dec.attn_rnn.bias_ih,
        dec.attn_rnn.weight_hh, dec.attn_rnn.bias_hh,
        lsa.conv.weight, lsa.conv.bias, lsa.L.weight, lsa.W.weight, lsa.W.bias,
        lsa.v.weight,
        dec.rnn_input.weight, dec.rnn_input.bias,
        dec.res_rnn1.weight_ih, dec.res_rnn1.weight_hh,
        dec.res_rnn1.bias_ih, dec.res_rnn1.bias_hh,
        dec.res_rnn2.weight_ih, dec.res_rnn2.weight_hh,
        dec.res_rnn2.bias_ih, dec.res_rnn2.bias_hh,
        dec.mel_proj.weight, dec.stop_proj.weight, dec.stop_proj.bias,
    ]
    return [w.detach().contiguous() for w in ws]


def tacotron_decode(model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                    encoder_seq_proj: Tensor, char_mask: Tensor, seed: int, r: int,
                    max_steps: int, dropout: bool = True
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`tacotron_decode_plain`; CUDA tensors go
    through the kernel."""
    if not encoder_seq.is_cuda:
        return tacotron_decode_plain(model, d, encoder_seq, encoder_seq_proj,
                                     char_mask, seed, r, max_steps, dropout)
    B, T, E = encoder_seq.shape
    dev = encoder_seq.device
    D, L, M = d.decoder_dims, d.lstm_dims, d.n_mels
    if not 1 <= r <= d.max_r:
        raise ValueError(f"tacotron_decode: r={r} outside [1, {d.max_r}]")
    for name, t, shape in (("encoder_seq", encoder_seq, (B, T, E)),
                           ("encoder_seq_proj", encoder_seq_proj, (B, T, D)),
                           ("char_mask", char_mask, (B, T))):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"tacotron_decode: {name} must be f32 on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"tacotron_decode: {name} must be contiguous {shape}, "
                             f"got {tuple(t.shape)}")
    weights = decoder_weights(model)
    for w in weights:
        if w.device != dev or w.dtype != torch.float32:
            raise ValueError(f"tacotron_decode: weights must be f32 on {dev}")
    conv = model.decoder.attn_net.conv.weight
    n_filters, ksize = conv.shape[0], conv.shape[2]
    max_iters = max(max_steps // r, 1)
    drop_thr = math.ceil(d.dropout * (1 << 24))  # keep iff 24 random bits ≥ thr
    lib = _build.library()
    dims = [B, T, E, D, L, 2 * D, M, d.max_r, r, max_iters, n_filters, ksize,
            int(bool(dropout)), drop_thr, 0]
    work_floats = lib.rtvc_tacotron_workspace(_build.int_array(dims))
    dims[-1] = work_floats
    work = torch.empty(work_floats, device=dev, dtype=torch.float32)
    mel = torch.empty((B, M, max_iters * r), device=dev, dtype=torch.float32)
    attn = torch.empty((B, max_iters, T), device=dev, dtype=torch.float32)
    stops = torch.empty((B, max_iters), device=dev, dtype=torch.float32)
    err = lib.rtvc_tacotron_decode(
        _build.pointer_array(weights), _build.int_array(dims),
        int(seed) & 0xFFFFFFFFFFFFFFFF, encoder_seq.data_ptr(),
        encoder_seq_proj.data_ptr(), char_mask.data_ptr(), mel.data_ptr(),
        attn.data_ptr(), stops.data_ptr(), work.data_ptr(),
        _build.stream_handle(dev),
    )
    _build.check(err, "rtvc_tacotron_decode")
    _build.launch_counts["tacotron_decode"] += 1
    return mel, attn, stops
