"""K1: the WaveRNN autoregressive sample loop, for the fatchord, geneing
and runtimeracer variants and the categorical, MOL and beta heads.

``wavernn_generate_core`` launches the CUDA kernel in
``csrc/wavernn_generate.cu`` for CUDA tensors and runs
``wavernn_generate_core_plain`` for CPU tensors. It replaces
``rtvc_tpu/ops/pallas/wavernn_kernel.py:generate_core_pallas``.

Inputs are the hoisted form ``models.wavernn`` prepares: ``weights`` (the
per-step weights, torch layout, from ``step_weights``) and ``streams`` (the
per-step conditioning projections, each (B, T, width), from ``hoist_aux``).
``LAYERS`` lists each variant's GRUs and FCs in order; a layer marked
``aux`` takes a stream as its additive term (``<name>_aux``) and keeps only
the state's columns of its input matrix (``<name>_wx``), the others have
their own bias (``<name>_wih`` / ``<name>_bih`` or ``<name>_w`` /
``<name>_b``).

The heads: ``categorical`` (Gumbel-argmax over the classes, the label
mapped to [-1, 1]), ``mol`` (a component of the logistic mixture by
Gumbel-argmax, then an inverse-CDF logistic draw) and ``beta`` (geneing's
RAW mode: Gα / (Gα + Gβ) from Marsaglia-Tsang gamma draws). The sampled
modes draw from a counter-based generator seeded by ``seed``: Philox-4x32-10
in the kernel, a ``torch.Generator`` in the plain version. The two give
different noise, so they agree in distribution; ``argmax=True`` (no noise:
the most likely class, the most likely component's clipped mean, the beta's
mode or mean) makes them agree sample for sample.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.models import distribution
from rtvc_tpu_torch.models.layers import gru_step

Tensor = torch.Tensor

VOC_FATCHORD = "fatchord-wavernn"
VOC_GENEING = "geneing-wavernn"
VOC_RUNTIMERACER = "runtimeracer-wavernn"

HEAD_CATEGORICAL = "categorical"
HEAD_MOL = "mol"
HEAD_BETA = "beta"
_HEAD_CODE = {HEAD_CATEGORICAL: 0, HEAD_MOL: 1, HEAD_BETA: 2}

# the kernel's layer slots (csrc/wavernn_generate.cu: kMaxRnn, kMaxFc)
_MAX_RNN = 4
_MAX_FC = 5


class Rnn(NamedTuple):
    name: str
    aux: bool = False


class Fc(NamedTuple):
    name: str
    aux: bool = False
    relu: bool = False


class LayerList(NamedTuple):
    rnns: Tuple[Rnn, ...]
    fcs: Tuple[Fc, ...]


LAYERS: Dict[str, LayerList] = {
    VOC_FATCHORD: LayerList(
        (Rnn("rnn1"), Rnn("rnn2", aux=True)),
        (Fc("fc1", aux=True, relu=True), Fc("fc2", aux=True, relu=True), Fc("fc3"))),
    VOC_GENEING: LayerList(
        (Rnn("rnn1"),),
        (Fc("fc1", aux=True, relu=True), Fc("fc3"))),
    VOC_RUNTIMERACER: LayerList(
        (Rnn("rnn1"), Rnn("rnn2"), Rnn("rnn3", aux=True), Rnn("rnn4")),
        (Fc("fc1", aux=True), Fc("fc2", relu=True), Fc("fc3", aux=True),
         Fc("fc4", relu=True), Fc("fc5"))),
}

# the launch count's name, one per variant
COUNT_NAME = {v: "wavernn_generate_" + v.split("-")[0] for v in LAYERS}


def weight_shapes(variant: str, R: int, F: int, C: int) -> Dict[str, tuple]:
    """Name → shape of every per-step weight of a variant, in kernel order."""
    layers = LAYERS[variant]
    shapes: Dict[str, tuple] = {"i_col": (R,)}
    for rnn in layers.rnns:
        if rnn.aux:
            shapes[f"{rnn.name}_wx"] = (3 * R, R)
        else:
            shapes[f"{rnn.name}_wih"] = (3 * R, R)
            shapes[f"{rnn.name}_bih"] = (3 * R,)
        shapes[f"{rnn.name}_whh"] = (3 * R, R)
        shapes[f"{rnn.name}_bhh"] = (3 * R,)
    n_in = R
    for k, fc in enumerate(layers.fcs):
        n_out = C if k == len(layers.fcs) - 1 else F
        if fc.aux:
            shapes[f"{fc.name}_wx"] = (n_out, n_in)
        else:
            shapes[f"{fc.name}_w"] = (n_out, n_in)
            shapes[f"{fc.name}_b"] = (n_out,)
        n_in = n_out
    return shapes


def stream_widths(variant: str, R: int, F: int) -> Dict[str, int]:
    """Name → width of every conditioning stream of a variant."""
    layers = LAYERS[variant]
    widths = {"i_cond": R}
    widths.update({f"{r.name}_aux": 3 * R for r in layers.rnns if r.aux})
    widths.update({f"{f.name}_aux": F for f in layers.fcs if f.aux})
    return widths


def _head_sample(head: str, logits: Tensor, argmax: bool, g: torch.Generator) -> Tensor:
    """One sampling step of a head: logits (B, C) → samples (B,) in [-1, 1]."""
    C = logits.shape[-1]
    if head == HEAD_MOL:
        if not argmax:
            return distribution.sample_from_discretized_mix_logistic(g, logits[:, :, None])[:, 0]
        k = C // 3
        comp = torch.argmax(logits[:, :k], dim=-1, keepdim=True)
        return logits[:, k:2 * k].gather(-1, comp)[:, 0].clamp(-1.0, 1.0)
    if head == HEAD_BETA:
        if not argmax:
            return distribution.sample_from_beta_dist(g, logits)
        alpha = torch.exp(logits[:, 0].clamp(-30.0, 30.0))
        beta = torch.exp(logits[:, 1].clamp(-30.0, 30.0))
        m = torch.where((alpha > 1.0) & (beta > 1.0),
                        (alpha - 1.0) / (alpha + beta - 2.0), alpha / (alpha + beta))
        return (2.0 * m - 1.0).clamp(-1.0, 1.0)
    if not argmax:
        u = torch.rand(logits.shape, generator=g, device=logits.device).clamp_(min=1e-9)
        logits = logits - torch.log(-torch.log(u))
    label = torch.argmax(logits, dim=-1).to(torch.float32)
    return 2.0 * label / (C - 1.0) - 1.0


def wavernn_generate_core_plain(weights: Dict[str, Tensor], streams: Dict[str, Tensor],
                                seed: int, argmax: bool = False,
                                return_logits: bool = False,
                                variant: str = VOC_RUNTIMERACER,
                                head: str = HEAD_CATEGORICAL):
    """Plain PyTorch sample loop → samples (B, T) in [-1, 1] (and, with
    ``return_logits``, the head's inputs (B, T, C) at each step)."""
    w, s = weights, streams
    layers = LAYERS[variant]
    i_cond = s["i_cond"]
    B, T, R = i_cond.shape
    dev = i_cond.device
    last = layers.fcs[-1]
    C = w[f"{last.name}_w"].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    h = [i_cond.new_zeros((B, R)) for _ in layers.rnns]
    prev = i_cond.new_zeros((B,))
    out = i_cond.new_empty((B, T))
    trace = i_cond.new_empty((B, T, C)) if return_logits else None
    for t in range(T):
        x = i_cond[:, t] + prev[:, None] * w["i_col"][None, :]
        for k, rnn in enumerate(layers.rnns):
            if rnn.aux:
                xg = x @ w[f"{rnn.name}_wx"].t() + s[f"{rnn.name}_aux"][:, t]
            else:
                xg = x @ w[f"{rnn.name}_wih"].t() + w[f"{rnn.name}_bih"]
            h[k] = gru_step(xg, h[k], w[f"{rnn.name}_whh"], w[f"{rnn.name}_bhh"])
            x = x + h[k]
        f = x
        for fc in layers.fcs:
            if fc.aux:
                f = f @ w[f"{fc.name}_wx"].t() + s[f"{fc.name}_aux"][:, t]
            else:
                f = f @ w[f"{fc.name}_w"].t() + w[f"{fc.name}_b"]
            if fc.relu:
                f = torch.relu(f)
        if trace is not None:
            trace[:, t] = f
        prev = _head_sample(head, f, argmax, g)
        out[:, t] = prev
    return (out, trace) if return_logits else out


def _slots(variant: str, weights: Dict[str, Tensor], streams: Dict[str, Tensor]
           ) -> Tuple[List, List, List[int]]:
    """The kernel's pointer slots (None where a layer or a bias is absent)
    and its FC relu flags."""
    layers = LAYERS[variant]
    w: List = [weights["i_col"]]
    s: List = [streams["i_cond"]]
    for k in range(_MAX_RNN):
        rnn = layers.rnns[k] if k < len(layers.rnns) else None
        if rnn is None:
            w += [None] * 4
            s.append(None)
        elif rnn.aux:
            w += [weights[f"{rnn.name}_wx"], None, weights[f"{rnn.name}_whh"],
                  weights[f"{rnn.name}_bhh"]]
            s.append(streams[f"{rnn.name}_aux"])
        else:
            w += [weights[f"{rnn.name}_{n}"] for n in ("wih", "bih", "whh", "bhh")]
            s.append(None)
    relu = []
    for k in range(_MAX_FC):
        fc = layers.fcs[k] if k < len(layers.fcs) else None
        relu.append(int(fc is not None and fc.relu))
        if fc is None:
            w += [None, None]
            s.append(None)
        elif fc.aux:
            w += [weights[f"{fc.name}_wx"], None]
            s.append(streams[f"{fc.name}_aux"])
        else:
            w += [weights[f"{fc.name}_w"], weights[f"{fc.name}_b"]]
            s.append(None)
    return w, s, relu


def wavernn_generate_core(weights: Dict[str, Tensor], streams: Dict[str, Tensor],
                          seed: int, argmax: bool = False, return_logits: bool = False,
                          variant: str = VOC_RUNTIMERACER, head: str = HEAD_CATEGORICAL):
    """Same contract as :func:`wavernn_generate_core_plain`; CUDA tensors go
    through the kernel."""
    i_cond = streams["i_cond"]
    if not i_cond.is_cuda:
        return wavernn_generate_core_plain(weights, streams, seed, argmax, return_logits,
                                           variant, head)
    layers = LAYERS[variant]
    B, T, R = i_cond.shape
    first, last = layers.fcs[0], layers.fcs[-1]
    F = weights[f"{first.name}_wx" if first.aux else f"{first.name}_w"].shape[0]
    C = weights[f"{last.name}_w"].shape[0]
    if head == HEAD_MOL and (C < 3 or C % 3):
        raise ValueError(f"wavernn_generate: the MOL head needs 3·k columns, got {C}")
    if head == HEAD_BETA and C != 2:
        raise ValueError(f"wavernn_generate: the beta head needs 2 columns, got {C}")
    dev = i_cond.device
    _build.check_tensors("wavernn_generate", dev, **{
        name: (weights[name], shape) for name, shape in weight_shapes(variant, R, F, C).items()})
    _build.check_tensors("wavernn_generate", dev, **{
        name: (streams[name], (B, T, width))
        for name, width in stream_widths(variant, R, F).items()})
    w, s, relu = _slots(variant, weights, streams)
    lib = _build.library()
    out = torch.empty((B, T), device=dev, dtype=torch.float32)
    trace = torch.empty((B, T, C), device=dev) if return_logits else None
    err = lib.rtvc_wavernn_generate(
        _build.pointer_array(w), _build.pointer_array(s),
        _build.int_array([B, T, R, F, C, len(layers.rnns), len(layers.fcs),
                          _HEAD_CODE[head], *relu]),
        int(bool(argmax)), int(seed) & 0xFFFFFFFFFFFFFFFF, out.data_ptr(),
        None if trace is None else trace.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "rtvc_wavernn_generate")
    _build.launch_counts[COUNT_NAME[variant]] += 1
    return (out, trace) if return_logits else out
