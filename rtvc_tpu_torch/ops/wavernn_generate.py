"""K1: the WaveRNN autoregressive sample loop, for the fatchord, geneing
and runtimeracer variants and the categorical, MOL and beta heads.

``wavernn_generate_core`` launches the CUDA kernel in
``csrc/wavernn_generate.cu`` for CUDA tensors and runs
``wavernn_generate_core_plain`` for CPU tensors. It replaces
``rtvc_tpu/ops/pallas/wavernn_kernel.py:generate_core_pallas``. The kernel
is one cooperative launch over the card: every CTA keeps a slice of every
layer's rows in shared memory, all folds ride in every CTA, reading each
layer's inputs from L2, and a grid barrier follows each dependent layer of
a step; :func:`plan` cuts the layers over the CTAs. On an H100 at 700 W
runtimeracer takes 28.7 µs a step at a 5 s clone's 13 folds, where the
barriers' waits are a third of it, and 98.8 µs at a paragraph's 169, where
the products are two thirds (PERF.md, section 6). The categorical head's
second half reads the last FC's partials a slice of CTAs a warp and 32
folds a load, and an FC's items are as wide as its CTA's rows; copying the
layers' inputs once a cluster into shared memory instead was slower at
every fold count, and is not here.

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

Types: the weights' dtype is the JAX kernel's ``compute_dtype`` and the
streams' its ``stream_dtype`` (``generate_core_pallas``:317-330), each f32
or bf16, and the pair picks the kernel's instantiation. bf16 streams are
widened where they are read; bf16 weights are resident at two bytes each
(:func:`plan` counts them so), and the carried GRU states and the fed-back
sample are rounded to bf16 where they are stored, while the residual
``x + h`` takes the new state before its rounding, as in the JAX kernel's
body. Every product accumulates in f32 and the samples come out f32. The
f32 kernel's launches are counted by variant (``COUNT_NAME``), the other
three instantiations' by pair (``PAIR_COUNT_NAME``), whatever the variant.
A bf16 CUDA tensor reaches its instantiation or raises.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.models import distribution
from rtvc_tpu_torch.models.layers import gru_step
from rtvc_tpu_torch.ops.precision import widen
from rtvc_tpu_torch.utils.profiler import count, span

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

# the launch count's name, one per variant (the f32 kernel) and one per
# (weights, streams) dtype pair of the other instantiations
COUNT_NAME = {v: "wavernn_generate_" + v.split("-")[0] for v in LAYERS}
PAIR_COUNT_NAME = {(torch.float32, torch.bfloat16): "wavernn_generate_bf16_streams",
                   (torch.bfloat16, torch.bfloat16): "wavernn_generate_bf16",
                   (torch.bfloat16, torch.float32): "wavernn_generate_bf16_weights"}


def count_name(variant: str, weight_dtype: torch.dtype, stream_dtype: torch.dtype) -> str:
    """The launch count a launch of these dtypes adds to."""
    if weight_dtype == stream_dtype == torch.float32:
        return COUNT_NAME[variant]
    return PAIR_COUNT_NAME[(weight_dtype, stream_dtype)]


def dtypes(weights: Dict[str, Tensor], streams: Dict[str, Tensor]
           ) -> Tuple[torch.dtype, torch.dtype]:
    """(the weights' dtype, the streams' dtype): each set must share one.
    Raises ValueError otherwise."""
    w = {t.dtype for t in weights.values()}
    s = {t.dtype for t in streams.values()}
    if len(w) != 1 or len(s) != 1:
        raise ValueError(f"wavernn_generate: the weights must share one dtype and the streams "
                         f"one, got {sorted(map(str, w))} and {sorted(map(str, s))}")
    return w.pop(), s.pop()

WARPS = 8        # warps of a CTA (csrc/common.cuh:kRecWarps)
ROW_BLOCK = 8    # weight rows an item of a layer's product takes (kRowBlock)
FOLD_PASSES = (4, 8)  # the kernel's instantiations: folds an item takes
WIDE_FOLDS = 64  # from this many folds on, items take 8 folds
MAX_FOLD_BLOCK = 512  # folds of the phase buffer at most


class Plan(NamedTuple):
    """How a launch is cut over the card: ``ctas`` CTAs, each owning
    ``units`` hidden units of every GRU, ``fc_rows`` rows of every FC but the
    last and ``last_rows`` of the last (a multiple of 4 for a categorical
    head: Philox gives four draws at once); a layer's product is cut into
    items of ``nb`` folds; the phase buffer holds ``fb`` folds; a CTA needs
    ``smem`` bytes of shared memory."""
    ctas: int
    units: int
    fc_rows: int
    last_rows: int
    nb: int
    fb: int
    smem: int


def _al4(n: int) -> int:
    return -(-n // 4) * 4


def _blocks(n: int) -> int:
    return -(-n // ROW_BLOCK) * ROW_BLOCK


def _smem_bytes(variant: str, R: int, F: int, head: str, B: int, units: int,
                fc_rows: int, last_rows: int, nb: int, fb: int, elem: int = 4) -> int:
    """Bytes of a CTA's shared memory: the arithmetic of
    ``csrc/wavernn_generate.cu:layout``. The weight rows, the biases and
    i_col's units take ``elem`` bytes an entry (4 for f32 weights, 2 for
    bf16), rounded up to 16 bytes; the rest is f32."""
    layers = LAYERS[variant]
    g_rows = _blocks(3 * units)
    w = len(layers.rnns) * (2 * g_rows * _al4(R) + 2 * _al4(3 * units)) + _al4(units)
    qs = [fc_rows] * (len(layers.fcs) - 1) + [last_rows]
    for k, q in enumerate(qs):
        w += _blocks(q) * _al4(R if k == 0 else F) + _al4(q)
    n = _al4(3 * units) + WARPS * (-(-ROW_BLOCK * nb // 32) * 32)
    n += max(2 * g_rows, _blocks(max(qs))) * fb
    if head == HEAD_CATEGORICAL:
        n += _al4(2 * (last_rows // 4) * fb)
    return -(-elem * w // 16) * 16 + 4 * (n + _al4(B))


def plan(variant: str, R: int, F: int, C: int, B: int, sm_count: int, smem_limit: int,
         head: str = HEAD_CATEGORICAL, elem: int = 4) -> Plan:
    """The partition of a variant's sample loop for B folds on a card with
    ``sm_count`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory, the weights resident at ``elem`` bytes each (4 for f32, 2 for
    bf16): every layer's rows cut evenly over at most ``sm_count`` CTAs (one
    a SM, all resident at once), items of 4 folds below ``WIDE_FOLDS`` folds
    and 8 from there on, and the phase buffer as many folds wide as fit (at
    most B, at most ``MAX_FOLD_BLOCK``). Raises ValueError, naming the limit,
    where a CTA's weights do not fit its shared memory or the folds' samples
    do not fit beside them."""
    if min(R, F, C, B, sm_count) < 1 or variant not in LAYERS:
        raise ValueError(f"wavernn_generate: bad plan inputs {variant} R {R} F {F} C {C} "
                         f"B {B} SMs {sm_count}")
    units, fc_rows = -(-R // sm_count), -(-F // sm_count)
    last_rows = -(-C // sm_count)
    if head == HEAD_CATEGORICAL:
        last_rows = _al4(last_rows)
    ctas = max(-(-R // units), -(-F // fc_rows), -(-C // last_rows))
    nb = FOLD_PASSES[1] if B >= WIDE_FOLDS else FOLD_PASSES[0]
    least = _smem_bytes(variant, R, F, head, 1, units, fc_rows, last_rows, nb, nb, elem)
    if least > smem_limit:
        raise ValueError(
            f"wavernn_generate: {variant} at R {R}, F {F}, C {C} needs {least} bytes of shared "
            f"memory a CTA on {sm_count} SMs, past the limit of {smem_limit} (its weights must "
            f"fit the card's shared memory)")
    for fb in range(min(-(-B // nb), MAX_FOLD_BLOCK // nb) * nb, 0, -nb):
        smem = _smem_bytes(variant, R, F, head, B, units, fc_rows, last_rows, nb, fb, elem)
        if smem <= smem_limit:
            return Plan(ctas, units, fc_rows, last_rows, nb, fb, smem)
    widest = (smem_limit - least) // 4 + 1  # each fold beyond the first takes a float
    raise ValueError(f"wavernn_generate: {B} folds are past the limit of {widest} for "
                     f"{variant} with {smem_limit} bytes of shared memory a CTA")


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
    ``return_logits``, the head's inputs (B, T, C) at each step). bf16
    weights or streams are widened to f32 for the arithmetic; under bf16
    weights the carried GRU states and the fed-back sample are rounded to
    bf16 where the kernel stores them (the residual takes the state before
    its rounding)."""
    w = {k: widen(v) for k, v in weights.items()}
    s = {k: widen(v) for k, v in streams.items()}
    weight_dtype, _ = dtypes(weights, streams)

    def stored(v: Tensor) -> Tensor:  # v as a carried value of the weights' dtype holds it
        return v.to(weight_dtype).to(v.dtype) if weight_dtype == torch.bfloat16 else v

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
            h_new = gru_step(xg, h[k], w[f"{rnn.name}_whh"], w[f"{rnn.name}_bhh"])
            x = x + h_new
            h[k] = stored(h_new)
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
        sample = _head_sample(head, f, argmax, g)
        out[:, t] = sample
        prev = stored(sample)
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
    through the kernel's instantiation for their dtypes. Counts the samples
    generated, folds × steps (``rtvc.vocoder.k1_samples``)."""
    B, T, _ = streams["i_cond"].shape
    with span("rtvc.vocoder.k1"):
        if not streams["i_cond"].is_cuda:
            with span("rtvc.vocoder.k1_launch"):
                out = wavernn_generate_core_plain(weights, streams, seed, argmax, return_logits,
                                                  variant, head)
        else:
            out = launch(_build.library(), weights, streams, seed, argmax, return_logits,
                         variant, head)
            _build.count_launch(count_name(variant, *dtypes(weights, streams)))
    count("rtvc.vocoder.k1_samples", B * T)
    return out


def launch(lib, weights: Dict[str, Tensor], streams: Dict[str, Tensor], seed: int,
           argmax: bool, return_logits: bool, variant: str, head: str):
    """One launch of ``lib``'s ``rtvc_wavernn_generate`` (the package's
    library, or a variant of it that ``profile_wavernn`` builds) on CUDA
    tensors, after the shape and dtype checks and with this device's plan
    for the weights' dtype. The samples (and head inputs) come out f32."""
    i_cond = streams["i_cond"]
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
    wdt, sdt = dtypes(weights, streams)
    _build.check_tensors("wavernn_generate", dev, **{
        name: (weights[name], shape, wdt)
        for name, shape in weight_shapes(variant, R, F, C).items()})
    _build.check_tensors("wavernn_generate", dev, **{
        name: (streams[name], (B, T, width), sdt)
        for name, width in stream_widths(variant, R, F).items()})
    w, s, relu = _slots(variant, weights, streams)
    w_bytes, s_bytes = _build.elem_bytes(wdt), _build.elem_bytes(sdt)
    p = plan(variant, R, F, C, B, *_build.device_limits(dev), head=head, elem=w_bytes)
    out = torch.empty((B, T), device=dev, dtype=torch.float32)
    trace = torch.empty((B, T, C), device=dev, dtype=torch.float32) if return_logits else None
    # GRU states (two a layer), activations (two), head inputs, partials
    scratch = torch.zeros(len(layers.rnns) * 2 * B * R + 2 * B * _al4(max(R, F)) + B * C
                          + 2 * p.ctas * B, device=dev, dtype=torch.float32)
    sync = torch.zeros(32, device=dev, dtype=torch.int32)
    with span("rtvc.vocoder.k1_launch"):
        err = lib.rtvc_wavernn_generate(
            _build.pointer_array(w), _build.pointer_array(s),
            _build.int_array([B, T, R, F, C, len(layers.rnns), len(layers.fcs),
                              _HEAD_CODE[head], *relu, *p, w_bytes, s_bytes]),
            int(bool(argmax)), int(seed) & 0xFFFFFFFFFFFFFFFF, scratch.data_ptr(),
            sync.data_ptr(), out.data_ptr(), None if trace is None else trace.data_ptr(),
            _build.stream_handle(dev),
        )
    _build.check(err, "rtvc_wavernn_generate")
    return (out, trace) if return_logits else out
