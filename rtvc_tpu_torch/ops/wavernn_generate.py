"""K1: the WaveRNN autoregressive sample loop (runtimeracer, RAW head).

``wavernn_generate_core`` launches the CUDA kernel in
``csrc/wavernn_generate.cu`` for CUDA tensors and runs
``wavernn_generate_core_plain`` for CPU tensors. It replaces
``rtvc_tpu/ops/pallas/wavernn_kernel.py:generate_core_pallas``.

Inputs are the hoisted form ``models.wavernn`` prepares: ``weights`` (the
per-step weights, torch layout, from ``step_weights``) and ``streams`` (the
per-step conditioning projections, each (B, T, width), from ``hoist_aux``).
The sampled mode draws Gumbel noise from a counter-based generator seeded
by ``seed``: Philox-4x32-10 in the kernel, a ``torch.Generator`` in the
plain version. The two give different noise, so they agree in distribution;
``argmax=True`` (no noise) makes them agree sample for sample.
"""
from __future__ import annotations

from typing import Dict

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.models.layers import gru_step

Tensor = torch.Tensor

WEIGHT_ORDER = (
    "i_col",
    "rnn1_wih", "rnn1_bih", "rnn1_whh", "rnn1_bhh",
    "rnn2_wih", "rnn2_bih", "rnn2_whh", "rnn2_bhh",
    "rnn3_wx", "rnn3_whh", "rnn3_bhh",
    "rnn4_wih", "rnn4_bih", "rnn4_whh", "rnn4_bhh",
    "fc1_wx", "fc2_w", "fc2_b", "fc3_wx", "fc4_w", "fc4_b", "fc5_w", "fc5_b",
)
STREAM_ORDER = ("i_cond", "rnn3_aux", "fc1_aux", "fc3_aux")


def _shapes(R: int, F: int, C: int) -> Dict[str, tuple]:
    return {
        "i_col": (R,),
        **{f"rnn{k}_{n}": s for k in (1, 2, 4) for n, s in
           (("wih", (3 * R, R)), ("bih", (3 * R,)), ("whh", (3 * R, R)),
            ("bhh", (3 * R,)))},
        "rnn3_wx": (3 * R, R), "rnn3_whh": (3 * R, R), "rnn3_bhh": (3 * R,),
        "fc1_wx": (F, R), "fc2_w": (F, F), "fc2_b": (F,), "fc3_wx": (F, F),
        "fc4_w": (F, F), "fc4_b": (F,), "fc5_w": (C, F), "fc5_b": (C,),
    }


def wavernn_generate_core_plain(weights: Dict[str, Tensor],
                                streams: Dict[str, Tensor], seed: int,
                                argmax: bool = False,
                                return_logits: bool = False):
    """Plain PyTorch sample loop → samples (B, T) in [-1, 1] (and, with
    ``return_logits``, the logits (B, T, C) each step sampled from)."""
    w, s = weights, streams
    i_cond = s["i_cond"]
    B, T, R = i_cond.shape
    dev = i_cond.device
    C = w["fc5_w"].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    h = [i_cond.new_zeros((B, R)) for _ in range(4)]
    prev = i_cond.new_zeros((B,))
    out = i_cond.new_empty((B, T))
    trace = i_cond.new_empty((B, T, C)) if return_logits else None
    for t in range(T):
        x = i_cond[:, t] + prev[:, None] * w["i_col"][None, :]
        for k, name in enumerate(("rnn1", "rnn2", "rnn3", "rnn4")):
            if name == "rnn3":
                xg = x @ w["rnn3_wx"].t() + s["rnn3_aux"][:, t]
            else:
                xg = x @ w[f"{name}_wih"].t() + w[f"{name}_bih"]
            h[k] = gru_step(xg, h[k], w[f"{name}_whh"], w[f"{name}_bhh"])
            x = x + h[k]
        f = x @ w["fc1_wx"].t() + s["fc1_aux"][:, t]
        f = torch.relu(f @ w["fc2_w"].t() + w["fc2_b"])
        f = f @ w["fc3_wx"].t() + s["fc3_aux"][:, t]
        f = torch.relu(f @ w["fc4_w"].t() + w["fc4_b"])
        logits = f @ w["fc5_w"].t() + w["fc5_b"]
        if trace is not None:
            trace[:, t] = logits
        if not argmax:
            u = torch.rand((B, C), generator=g, device=dev).clamp_(min=1e-9)
            logits = logits - torch.log(-torch.log(u))
        label = torch.argmax(logits, dim=-1).to(torch.float32)
        prev = 2.0 * label / (C - 1.0) - 1.0
        out[:, t] = prev
    return (out, trace) if return_logits else out


def wavernn_generate_core(weights: Dict[str, Tensor], streams: Dict[str, Tensor],
                          seed: int, argmax: bool = False, return_logits: bool = False):
    """Same contract as :func:`wavernn_generate_core_plain`; CUDA tensors go
    through the kernel."""
    i_cond = streams["i_cond"]
    if not i_cond.is_cuda:
        return wavernn_generate_core_plain(weights, streams, seed, argmax, return_logits)
    B, T, R = i_cond.shape
    F = weights["fc2_w"].shape[0]
    C = weights["fc5_w"].shape[0]
    dev = i_cond.device
    expect = _shapes(R, F, C)
    stream_w = {"i_cond": R, "rnn3_aux": 3 * R, "fc1_aux": F, "fc3_aux": F}
    for name in WEIGHT_ORDER:
        _check(name, weights[name], expect[name], dev)
    for name in STREAM_ORDER:
        _check(name, streams[name], (B, T, stream_w[name]), dev)
    lib = _build.library()
    out = torch.empty((B, T), device=dev, dtype=torch.float32)
    trace = torch.empty((B, T, C), device=dev) if return_logits else None
    err = lib.rtvc_wavernn_generate(
        _build.pointer_array([weights[n] for n in WEIGHT_ORDER]),
        _build.pointer_array([streams[n] for n in STREAM_ORDER]),
        _build.int_array([B, T, R, F, C]), int(bool(argmax)),
        int(seed) & 0xFFFFFFFFFFFFFFFF, out.data_ptr(),
        None if trace is None else trace.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "rtvc_wavernn_generate")
    _build.launch_counts["wavernn_generate"] += 1
    return (out, trace) if return_logits else out


def _check(name: str, t: Tensor, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"wavernn_generate: {name} must be f32 on {dev}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"wavernn_generate: {name} must be contiguous {shape}, "
                         f"got {tuple(t.shape)}")
