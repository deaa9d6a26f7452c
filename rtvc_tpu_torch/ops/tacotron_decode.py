"""K2: the Tacotron inference decoder loop.

``tacotron_decode`` launches the CUDA kernel in ``csrc/tacotron_decode.cu``
for CUDA tensors and runs ``tacotron_decode_plain`` (a Python loop of
``models.tacotron.decoder_step``) for CPU tensors. It replaces
``rtvc_tpu/ops/pallas/tacotron_kernel.py:decode_pallas``.

Both take the ``encode()`` outputs and return (mel (B, n_mels, max_iters·r),
attn (B, max_iters, T), stops (B, max_iters)), zero past the iteration where
every stop token fired. Prenet dropout stays on unless ``dropout=False``;
its noise comes from ``seed`` (Philox-4x32-10 in the kernel, keyed by the
absolute iteration; a ``torch.Generator`` in the plain version), so the two
agree exactly only with dropout off.

``tacotron_decode_chunk`` (plain twin ``tacotron_decode_chunk_plain``, a
loop of ``decoder_step``) resumes a decode: ``n_iters`` iterations from a
carried ``DecoderCarry`` and previous frame, counted from ``start_iter``,
with ``min_iters`` and a ``done`` flag (the contract of the JAX package's
chunk decoder, ``rtvc_tpu/inference/streaming.py:_make_chunk_decoder``):
iterations after the stop write ``pad_value`` and leave the carry as it was
at the stop. It is the same kernel; ``tacotron_decode`` is its zero-carry,
whole-utterance case. Chunks of one decode, joined, give the bits of one
launch.

The kernel is one cooperative launch over the card: every CTA owns a slice
of the rows (or of the units) of every product of an iteration, for all
batch rows at once, and a grid barrier ends each of the ten dependent phases
of an iteration. :func:`plan` cuts the products over the CTAs, decides
whether the weight slices stay in shared memory for the whole launch, and
lays out the shared memory and the workspace; the kernel takes every offset
from it.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.models.tacotron import (
    DecoderCarry,
    Tacotron,
    TacotronDims,
    decode_loop,
    decoder_step,
)

Tensor = torch.Tensor

THREADS = 256    # threads of a CTA (csrc/common.cuh:kRecThreads)
WARPS = THREADS // 32
ROW_BLOCK = 4    # weight rows an item of a product takes (kRowBlock)
CHUNK = 128      # floats of the reduction axis a warp covers at once
NB_CHOICES = (2, 4, 8)  # the kernel's instantiations: batch rows an item takes
MAX_FILTERS = 32  # location filters a thread keeps in registers (kMaxFilters)
CONV_PAIRS = 32  # (row, character) pairs a CTA convolves at once
SPARE_PAIRS = 4  # pairs a CTA takes at most to keep them off the mel CTAs
HEADER = 512     # floats of shared memory for the launch's parameters (kHeaderFloats)

# The cuts: the unit axis each product is sliced along, over the CTAs.
CUTS = ("fc", "gru", "query", "ri", "lstm", "mel", "stop", "pair", "ctx")
# The products of an iteration, in the kernel's order (csrc: enum Product).
PRODUCTS = ("fc1", "fc2", "gru_x", "gru_h", "gru_p", "query", "ri_a", "ri_c",
            "l1_h", "l2_h", "l1_i", "l2_i", "mel", "stop_c", "stop_x")
# Products whose single row is read from L2 in every plan.
ALWAYS_STREAMED = ("stop_c", "stop_x")
# The shared-memory offsets besides the products' (csrc: struct Plan).
SMEM_SLOTS = ("c1", "c2", "v", "conv_w", "conv_b", "soft", "soft_rows", "scratch", "part",
              "conv_buf", "conv_pairs", "bias", "ah_own", "x0_own", "x1_own", "qs", "end")
# The workspace's buffers after the barrier's 32 words (csrc: enum Ws).
WS_SLOTS = ("prev", "pre1", "pre2", "ctx", "ah", "q", "x0", "x1", "x2", "h1", "h2", "base",
            "u", "cum", "stop", "lt", "total")
# The decoder state a resumable launch reads and writes, in the kernel's
# order (csrc: struct Carry): DecoderCarry's fields, then the previous frame.
CARRY = DecoderCarry._fields + ("prev",)


class DecoderShape(NamedTuple):
    """The decoder's widths: encoder output E, attention D, LSTM L, prenet P,
    mels M, the model's largest r, location filters NF and taps KS."""
    E: int
    D: int
    L: int
    P: int
    M: int
    max_r: int
    NF: int
    KS: int

    @classmethod
    def of(cls, model: Tacotron, d: TacotronDims) -> "DecoderShape":
        conv = model.decoder.attn_net.conv.weight
        return cls(d.enc_out_dims, d.decoder_dims, d.lstm_dims, 2 * d.decoder_dims, d.n_mels,
                   d.max_r, conv.shape[0], conv.shape[2])


class Product(NamedTuple):
    cut: str
    gates: int   # weight rows a unit owns
    n: int       # length of the reduction axis
    phase: str   # the phase of an iteration it runs in (A-J)
    chained: bool  # on the iteration's chain (False: its inputs are ready a phase or more early)


def products(s: DecoderShape, r: int) -> Dict[str, Product]:
    E, D, L, P, M = s.E, s.D, s.L, s.P, s.M
    return {
        "fc1": Product("fc", 1, M, "A", True),
        "fc2": Product("fc", 1, P, "B", True),
        "gru_x": Product("gru", 3, E, "A", False),
        "gru_h": Product("gru", 3, D, "A", False),
        "gru_p": Product("gru", 3, P, "C", True),
        "query": Product("query", 1, D, "D", True),
        "ri_a": Product("ri", 1, D, "D", False),
        "ri_c": Product("ri", 1, E, "G", True),
        "l1_h": Product("lstm", 4, L, "B", False),
        "l2_h": Product("lstm", 4, L, "D", False),
        "l1_i": Product("lstm", 4, L, "H", True),
        "l2_i": Product("lstm", 4, L, "I", True),
        "mel": Product("mel", r, L, "J", True),
        "stop_c": Product("stop", 1, E, "G", False),
        "stop_x": Product("stop", 1, L, "J", True),
    }


def cut_sizes(s: DecoderShape, B: int, T: int) -> Dict[str, int]:
    """Units along each cut: prenet rows, GRU units, query rows, rnn_input
    rows, LSTM units, mel channels, the stop row, (row, character) pairs of
    the scores and (row, column) outputs of the context."""
    return {"fc": s.P, "gru": s.D, "query": s.D, "ri": s.L, "lstm": s.L, "mel": s.M,
            "stop": 1, "pair": B * T, "ctx": B * s.E}


class Plan(NamedTuple):
    """How a launch is cut over the card: ``ctas`` CTAs; ``nb`` batch rows an
    item of a product takes; ``resident`` 1 where the weight slices stay in
    shared memory for the whole launch, 0 where they are read from L2 every
    iteration; ``smem`` bytes of shared memory a CTA. For each cut (CUTS),
    ``q`` units a CTA and ``first``, the CTA that owns its first block (CTA c
    owns block (c - first) mod ctas). For each product (PRODUCTS), ``ks``
    pieces its reduction axis is cut into, ``w_off`` the offset of its weight
    slice in shared memory (-1: read from L2) and ``out_off`` that of its
    sums. ``sm`` holds the other shared-memory offsets (SMEM_SLOTS), ``ws``
    the workspace's (WS_SLOTS, in floats, after 32 words for the barrier)."""
    ctas: int
    nb: int
    resident: int
    smem: int
    q: Tuple[int, ...]
    first: Tuple[int, ...]
    ks: Tuple[int, ...]
    w_off: Tuple[int, ...]
    out_off: Tuple[int, ...]
    sm: Tuple[int, ...]
    ws: Tuple[int, ...]

    def ints(self):
        """The plan as the kernel reads it (csrc: struct Plan)."""
        out = [self.ctas, self.nb, self.resident, self.smem]
        for part in self[4:]:
            out.extend(part)
        return out

    def owned(self, cut: str, n: int, cta: int) -> range:
        """The units [0, n) of ``cut`` that CTA ``cta`` owns."""
        k = CUTS.index(cut)
        q = self.q[k]
        u0 = (cta - self.first[k]) % self.ctas * q
        return range(min(u0, n), min(u0 + q, n))


def _al4(n: int) -> int:
    return -(-n // 4) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bias_floats(q: Dict[str, int]) -> int:
    """Floats of a CTA's biases (csrc: bias_layout): prenet fc1 and fc2, the
    GRU's b_ih and b_hh, the query's, rnn_input's, both LSTMs' b_ih and b_hh,
    the stop row's."""
    sizes = (q["fc"], q["fc"], 3 * q["gru"], 3 * q["gru"], q["query"], q["ri"],
             *(4 * q["lstm"],) * 4, 1)
    return sum(_al4(n) for n in sizes)


def _rows_hull(q_pair: int, q_ctx: int, T: int, E: int, B: int, ctas: int) -> int:
    """The most batch rows whose softmax one CTA needs: the hull of the rows
    of its (row, character) pairs and of its context outputs."""
    most = 0
    for c in range(ctas):
        rows = []
        for q, n, width in ((q_pair, B * T, T), (q_ctx, B * E, E)):
            lo, hi = c * q, min((c + 1) * q, n)
            if lo < hi:
                rows += [lo // width, (hi - 1) // width]
        if rows:
            most = max(most, max(rows) - min(rows) + 1)
    return most


def plan(B: int, T: int, s: DecoderShape, r: int, sm_count: int, smem_limit: int,
         resident=None, nb=None) -> Plan:
    """The partition of the decoder loop for B texts of T characters at
    reduction ``r`` on a card with ``sm_count`` SMs whose blocks may take
    ``smem_limit`` bytes of shared memory. Every cut is spread evenly over
    ``sm_count`` CTAs (one a SM, all resident at once); the mel channels and
    the stop row sit on the last CTAs, and up to SPARE_PAIRS (row, character)
    pairs a CTA on the others where that covers them. A chained product whose items are
    fewer than the warps of a CTA cuts its reduction axis into as many pieces
    as make them up. The weight slices stay in shared memory where they fit
    (``resident`` None), else they are read from L2; ``resident`` and ``nb``
    force a choice (the profile and the tests use that). Raises ValueError,
    naming the limit, for a shape past it."""
    if min(B, T, sm_count, r, *s) < 1 or r > s.max_r:
        raise ValueError(f"tacotron_decode: bad plan inputs B {B} T {T} r {r} (max_r "
                         f"{s.max_r}) SMs {sm_count} {s}")
    if s.NF > MAX_FILTERS:
        raise ValueError(f"tacotron_decode: {s.NF} location filters are past the limit of "
                         f"{MAX_FILTERS}")
    if nb is None:
        nb = 2 if B <= 2 else 4 if B <= 12 else 8
    if nb not in NB_CHOICES:
        raise ValueError(f"tacotron_decode: nb {nb} is not one of {NB_CHOICES}")
    ctas = sm_count
    sizes = cut_sizes(s, B, T)
    q = {c: _cdiv(n, ctas) for c, n in sizes.items()}
    q["ctx"] = _al4(q["ctx"])  # the context is summed in groups of 4 columns
    first = {c: 0 for c in CUTS}
    first["mel"] = ctas - _cdiv(sizes["mel"], q["mel"])
    first["stop"] = ctas - 1
    # a few (row, character) pairs a CTA go to the CTAs without mel channels:
    # phase J computes the next location term beside the mel frames
    spare = first["mel"]
    if spare and _cdiv(sizes["pair"], spare) <= SPARE_PAIRS:
        q["pair"] = _cdiv(sizes["pair"], spare)
    prods = products(s, r)
    groups = _cdiv(B, nb)
    ks = {}
    for name, p in prods.items():
        items = p.gates * _cdiv(q[p.cut], ROW_BLOCK) * groups
        chunks = _cdiv(p.n, CHUNK)
        want = min(chunks, _cdiv(WARPS, items)) if p.chained else 1
        ks[name] = _cdiv(chunks, _cdiv(chunks, want))  # no piece left empty

    def out_floats(name):
        p = prods[name]
        return _al4(ks[name] * p.gates * q[p.cut] * B)

    def layout(keep_weights):
        o = HEADER
        w_off = {}
        for name, p in prods.items():
            if keep_weights and name not in ALWAYS_STREAMED:
                w_off[name] = o
                o += p.gates * q[p.cut] * _al4(p.n)
            else:
                w_off[name] = -1
        sm = {}
        for slot, n in (("v", s.D), ("conv_w", s.NF * s.KS), ("conv_b", s.NF)):
            sm[slot] = o
            o += _al4(n)
        out_off = {}
        for name, p in prods.items():
            if not p.chained:
                out_off[name] = o
                o += out_floats(name)
        for slot in ("c1", "c2"):
            sm[slot] = o
            o += _al4(q["lstm"] * B)
        # the chained products of one phase side by side; the phases share
        phase_base, widest = o, 0
        for phase in "ABCDEFGHIJ":
            at = phase_base
            for name, p in prods.items():
                if p.chained and p.phase == phase:
                    out_off[name] = at
                    at += out_floats(name)
            widest = max(widest, at - phase_base)
        o += widest
        sm["soft_rows"] = _rows_hull(q["pair"], q["ctx"], T, s.E, B, ctas)
        sm["soft"] = o
        o += sm["soft_rows"] * _al4(T)
        sm["scratch"] = o
        o += WARPS * 32
        # the context's pieces (phase F) and the location term's filters
        # (phase J) share a buffer
        sm["conv_pairs"] = min(q["pair"], CONV_PAIRS)
        sm["part"] = sm["conv_buf"] = o
        o += max(4 * THREADS, sm["conv_pairs"] * MAX_FILTERS)
        sm["bias"] = o
        o += _bias_floats(q)
        for slot, cut in (("ah_own", "gru"), ("x0_own", "ri"), ("x1_own", "lstm")):
            sm[slot] = o
            o += _al4(q[cut] * B)
        sm["qs"] = o
        o += sm["soft_rows"] * _al4(s.D)
        sm["end"] = o
        return w_off, out_off, sm, 4 * o

    choices = (True, False) if resident is None else (bool(resident),)
    for keep in choices:
        w_off, out_off, sm, smem = layout(keep)
        if smem <= smem_limit:
            break
    else:
        raise ValueError(
            f"tacotron_decode: B {B} x T {T} at r {r} needs {smem} bytes of shared memory a CTA "
            f"on {sm_count} SMs{' with its weights resident' if keep else ''}, past the limit "
            f"of {smem_limit}")
    ws, o = {}, 32
    for slot, n in (("prev", B * _al4(s.M)), ("pre1", B * _al4(s.P)), ("pre2", B * _al4(s.P)),
                    ("ctx", B * _al4(s.E)), ("ah", B * _al4(s.D)), ("q", B * _al4(s.D)),
                    ("x0", B * _al4(s.L)), ("x1", B * _al4(s.L)), ("x2", B * _al4(s.L)),
                    ("h1", B * _al4(s.L)), ("h2", B * _al4(s.L)),
                    ("base", B * T * _al4(s.D)), ("u", B * _al4(T)), ("cum", B * _al4(T)),
                    ("stop", _al4(B)), ("lt", _al4(s.NF * s.D))):
        ws[slot] = o
        o += n
    ws["total"] = o
    return Plan(ctas, nb, int(keep), smem, tuple(q[c] for c in CUTS),
                tuple(first[c] for c in CUTS), tuple(ks[p] for p in PRODUCTS),
                tuple(w_off[p] for p in PRODUCTS), tuple(out_off[p] for p in PRODUCTS),
                tuple(sm[k] for k in SMEM_SLOTS), tuple(ws[k] for k in WS_SLOTS))


def tacotron_decode_plain(model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                          encoder_seq_proj: Tensor, char_mask: Tensor, seed: int,
                          r: int, max_steps: int, dropout: bool = True
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    g = torch.Generator(device=encoder_seq.device).manual_seed(seed)
    return decode_loop(model, d, encoder_seq, encoder_seq_proj, char_mask, r,
                       max_steps, g, prenet_dropout=dropout)


class DecodeChunk(NamedTuple):
    """One resumable launch's outputs: mel (B, n_mels, n_iters·r), attn
    (B, n_iters, T) and stops (B, n_iters), the pad, zeros and zeros past the
    stop; the decoder state after the last iteration run (at the stop, if it
    fired) and its last frame (B, n_mels); ``done`` (int32 scalar) 1 once the
    stop has fired, here or before; ``valid`` (int32 scalar) the iterations
    run before the stop. The scalars stay on the tensors' device: reading
    them waits for the launch."""
    mel: Tensor
    attn: Tensor
    stops: Tensor
    carry: DecoderCarry
    prev: Tensor
    done: Tensor
    valid: Tensor


def _stop_fired(stop: Tensor, it: int, r: int, min_iters: int) -> bool:
    """The stop rule of iteration ``it`` (absolute): every stop token past
    0.5, after step 10 and not before ``min_iters``."""
    return it * r > 10 and it >= min_iters and bool((stop > 0.5).all())


def tacotron_decode_chunk_plain(model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                                encoder_seq_proj: Tensor, char_mask: Tensor, seed: int, r: int,
                                carry: DecoderCarry, prev: Tensor, done: Tensor,
                                start_iter: int, n_iters: int, min_iters: int = 0,
                                pad_value: float = 0.0, dropout: bool = True,
                                generator: Optional[torch.Generator] = None) -> DecodeChunk:
    """``n_iters`` iterations of ``decoder_step`` from ``carry`` and ``prev``.
    Its dropout draws from ``generator``, or from a new one of ``seed``: pass
    one generator through the chunks of a decode for the draws of one
    ``decode_loop``."""
    B, T, _ = encoder_seq.shape
    dev = encoder_seq.device
    g = generator
    if g is None and dropout:
        g = torch.Generator(device=dev).manual_seed(seed)
    mel = torch.full((B, d.n_mels, n_iters * r), float(pad_value), device=dev)
    attn = torch.zeros((B, n_iters, T), device=dev)
    stops = torch.zeros((B, n_iters), device=dev)
    fired, valid = bool(done), 0
    for i in range(n_iters):
        if fired:
            break
        carry, m, scores, stop = decoder_step(model, d, r, carry, prev, encoder_seq,
                                              encoder_seq_proj, char_mask, g, dropout)
        mel[:, :, i * r:(i + 1) * r] = m
        attn[:, i] = scores
        stops[:, i] = stop[:, 0]
        prev = m[:, :, -1]
        valid += 1
        fired = _stop_fired(stop, start_iter + i, r, min_iters)
    flag = torch.tensor(int(fired), dtype=torch.int32, device=dev)
    return DecodeChunk(mel, attn, stops, carry, prev, flag,
                       torch.tensor(valid, dtype=torch.int32, device=dev))


def tacotron_decode_chunk(model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                          encoder_seq_proj: Tensor, char_mask: Tensor, seed: int, r: int,
                          carry: DecoderCarry, prev: Tensor, done: Tensor, start_iter: int,
                          n_iters: int, min_iters: int = 0, pad_value: float = 0.0,
                          dropout: bool = True,
                          generator: Optional[torch.Generator] = None) -> DecodeChunk:
    """Same contract as :func:`tacotron_decode_chunk_plain`; CUDA tensors go
    through the kernel, whose dropout is keyed by ``seed`` and the absolute
    iteration (``generator`` is not read there)."""
    if not encoder_seq.is_cuda:
        return tacotron_decode_chunk_plain(model, d, encoder_seq, encoder_seq_proj, char_mask,
                                           seed, r, carry, prev, done, start_iter, n_iters,
                                           min_iters, pad_value, dropout, generator)
    out = launch_chunk(_build.library(), model, d, encoder_seq, encoder_seq_proj, char_mask,
                       seed, r, carry, prev, done, start_iter, n_iters, min_iters, pad_value,
                       dropout)
    _build.count_launch("tacotron_decode_chunk")
    return out


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
    out = launch(_build.library(), model, d, encoder_seq, encoder_seq_proj, char_mask, seed, r,
                 max_steps, dropout)
    _build.count_launch("tacotron_decode")
    return out


def launch(lib, model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
           encoder_seq_proj: Tensor, char_mask: Tensor, seed: int, r: int, max_steps: int,
           dropout: bool = True, p: Plan = None, work: Tensor = None
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch of ``lib``'s ``rtvc_tacotron_decode`` (the package's
    library, or a variant of it that ``profile_tacotron`` builds) on CUDA
    tensors, after the shape checks, with ``p`` or this device's plan, and
    ``work`` (zeroed, at least ``p.ws[-1]`` floats) or a new workspace: a
    whole decode from a zero state."""
    return _launch(lib, model, d, encoder_seq, encoder_seq_proj, char_mask, seed, r,
                   max(max_steps // r, 1), dropout, p, work)


def launch_chunk(lib, model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                 encoder_seq_proj: Tensor, char_mask: Tensor, seed: int, r: int,
                 carry: DecoderCarry, prev: Tensor, done: Tensor, start_iter: int, n_iters: int,
                 min_iters: int = 0, pad_value: float = 0.0, dropout: bool = True
                 ) -> DecodeChunk:
    """One resumable launch (:func:`tacotron_decode_chunk`'s contract) of
    ``lib``'s ``rtvc_tacotron_decode``."""
    B, T, _ = encoder_seq.shape
    dev = encoder_seq.device
    s = DecoderShape.of(model, d)
    widths = (s.D, s.L, s.L, s.L, s.L, s.E, T, s.M)
    state = (*carry, prev)
    _build.check_tensors("tacotron_decode_chunk", dev, **{
        name: (t, (B, n)) for name, t, n in zip(CARRY, state, widths)})
    if n_iters < 1 or start_iter < 0:
        raise ValueError(f"tacotron_decode_chunk: {n_iters} iterations from {start_iter}")
    done = torch.as_tensor(done, device=dev).to(torch.int32).reshape(1)
    out = [torch.empty_like(t) for t in state]
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    mel, attn, stops = _launch(lib, model, d, encoder_seq, encoder_seq_proj, char_mask, seed,
                               r, n_iters, dropout, None, None, start_iter, min_iters, pad_value,
                               state, out, done, flags)
    return DecodeChunk(mel, attn, stops, DecoderCarry(*out[:-1]), out[-1], flags[0], flags[1])


def _launch(lib, model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
            encoder_seq_proj: Tensor, char_mask: Tensor, seed: int, r: int, n_iters: int,
            dropout: bool, p: Optional[Plan], work: Optional[Tensor], start_iter: int = 0,
            min_iters: int = 0, pad_value: float = 0.0, carry_in=None, carry_out=None,
            done: Optional[Tensor] = None, flags: Optional[Tensor] = None
            ) -> Tuple[Tensor, Tensor, Tensor]:
    B, T, E = encoder_seq.shape
    dev = encoder_seq.device
    s = DecoderShape.of(model, d)
    if not 1 <= r <= d.max_r:
        raise ValueError(f"tacotron_decode: r={r} outside [1, {d.max_r}]")
    _build.check_tensors("tacotron_decode", dev, encoder_seq=(encoder_seq, (B, T, s.E)),
                         encoder_seq_proj=(encoder_seq_proj, (B, T, s.D)),
                         char_mask=(char_mask, (B, T)))
    weights = decoder_weights(model)
    for w in weights:
        if w.device != dev or w.dtype != torch.float32:
            raise ValueError(f"tacotron_decode: weights must be f32 on {dev}")
    if p is None:
        p = plan(B, T, s, r, *_build.device_limits(dev))
    max_iters = n_iters
    drop_thr = math.ceil(d.dropout * (1 << 24))  # keep iff 24 random bits ≥ thr
    dims = [B, T, s.E, s.D, s.L, s.P, s.M, s.max_r, r, max_iters, s.NF, s.KS,
            int(bool(dropout)), drop_thr, start_iter, min_iters]
    if work is None:
        work = torch.zeros(p.ws[-1], device=dev, dtype=torch.float32)
    elif work.numel() < p.ws[-1] or work.device != dev or work.dtype != torch.float32:
        raise ValueError(f"tacotron_decode: work must be at least {p.ws[-1]} f32 on {dev}")
    mel = torch.empty((B, s.M, max_iters * r), device=dev, dtype=torch.float32)
    attn = torch.empty((B, max_iters, T), device=dev, dtype=torch.float32)
    stops = torch.empty((B, max_iters), device=dev, dtype=torch.float32)
    ints = p.ints()
    err = lib.rtvc_tacotron_decode(
        _build.pointer_array(weights), _build.int_array(dims), len(dims), _build.int_array(ints),
        len(ints), int(seed) & 0xFFFFFFFFFFFFFFFF, encoder_seq.data_ptr(),
        encoder_seq_proj.data_ptr(), char_mask.data_ptr(), mel.data_ptr(), attn.data_ptr(),
        stops.data_ptr(), work.data_ptr(),
        None if carry_in is None else _build.pointer_array(carry_in),
        None if carry_out is None else _build.pointer_array(carry_out),
        None if done is None else done.data_ptr(), None if flags is None else flags.data_ptr(),
        float(pad_value), _build.stream_handle(dev),
    )
    _build.check(err, "rtvc_tacotron_decode")
    return mel, attn, stops
