"""The dual-softmax WaveRNN of the WaveRNN paper, the "deepmind" variant
(counterpart of ``rtvc_tpu/models/wavernn_deepmind.py``): one GRU whose
hidden state is split into a coarse and a fine half, 16-bit audio emitted
as two 8-bit categorical heads (coarse = the high byte, fine = the low byte,
conditioned on the current coarse sample).

The cell: with the previous labels y = (c_{t-1}, f_{t-1}) scaled to [-1, 1]
and the gates laid out [u | r | e], each H wide and each [coarse half | fine
half],

    u = σ(R_u h + i_u + b_u),  r = σ(R_r h + i_r + b_r),
    e = tanh(r ⊙ R_e h + i_e + b_e),  h' = u ⊙ h + (1 − u) ⊙ e,

where i = [I_coarse(y) | I_fine(y, c_t)] interleaved by gate and ``R`` has
no bias. That is torch's GRU with z = u and n = e, a hidden-side bias of
zero and a zero initial state, over inputs that do not depend on the
state: K4's contract (``ops.gru_seq``). So the teacher-forced pass
(:func:`deepmind_forward`) hoists both input products into two
full-sequence matmuls, sends the recurrence through K4 (``GRUSeqFn`` under
grad, ``gru_seq_fwd`` without; the plain versions for CPU tensors) with
``R``'s row blocks reordered from [u; r; e] to K4's [r; z; n], and applies
both heads to the stacked states.

Generation (:func:`deepmind_generate`) is the sample loop on the model's
device: one ``R(hidden)`` product a step, the coarse half-step, a
categorical draw, the fine half-step fed the drawn coarse label, a draw.
The draws are Gumbel-max over uniform noise from an explicit
``torch.Generator`` on the model's device, made a block of steps at a time,
so nothing returns to the host inside the loop. The JAX package has no
kernel for this loop, and neither has the port: it is plain PyTorch, and on
the card each block of steps is one replay of a CUDA graph of the steps'
small launches (launched one by one from Python, a step took 840 µs at
batch 1 on an H100: PERF.md, section 6).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rtvc_tpu_torch.models.layers import Linear
from rtvc_tpu_torch.ops.audio import combine_signal
from rtvc_tpu_torch.ops.gru_seq import GRUSeqFn, gru_seq_fwd

Tensor = torch.Tensor

# steps of the sample loop drawn at once, and replayed at once as a CUDA graph
STEP_BLOCK = 256


class DeepMindDims(NamedTuple):
    hidden: int = 896
    quantisation: int = 256

    @property
    def split(self) -> int:
        return self.hidden // 2


class DeepMindWaveRNN(nn.Module):
    """The parameters under the JAX package's names: ``R`` (3H x H, no
    bias), the heads ``O1``-``O4``, the input products ``I_coarse`` (3·split
    x 2) and ``I_fine`` (3·split x 3), no bias, and the gate biases
    ``bias_u``, ``bias_r``, ``bias_e``."""

    def __init__(self, d: DeepMindDims):
        super().__init__()
        H, s, Q = d.hidden, d.split, d.quantisation
        self.R = nn.Linear(H, 3 * H, bias=False)
        self.O1 = Linear(s, s)
        self.O2 = Linear(s, Q)
        self.O3 = Linear(s, s)
        self.O4 = Linear(s, Q)
        self.I_coarse = Linear(2, 3 * s, bias=False)
        self.I_fine = Linear(3, 3 * s, bias=False)
        self.bias_u = nn.Parameter(torch.zeros(H))
        self.bias_r = nn.Parameter(torch.zeros(H))
        self.bias_e = nn.Parameter(torch.zeros(H))


def _scale(labels: Tensor) -> Tensor:
    """8-bit label → float in [-1, 1]."""
    return labels.float() / 127.5 - 1.0


def _k4_operands(model: DeepMindWaveRNN, i_c: Tensor, i_f: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """K4's (xg, w_hh, b_hh) for the recurrence over the input products
    ``i_c`` / ``i_f`` (B, T, 3·split, each [u | r | e]): the halves
    interleaved as R's rows are ([coarse | fine] a gate), the gates in K4's
    order [r, z, n] with z = u and n = e, the gate biases folded into xg
    (the reset gate does not multiply b_e), and a zero hidden-side bias that
    takes no gradient."""
    H = model.bias_u.shape[0]
    cu, cr, ce = i_c.chunk(3, dim=-1)
    fu, fr, fe = i_f.chunk(3, dim=-1)
    bias = torch.cat([model.bias_r, model.bias_u, model.bias_e])
    xg = (torch.cat([cr, fr, cu, fu, ce, fe], dim=-1) + bias).contiguous()
    r_u, r_r, r_e = model.R.weight.split(H, dim=0)
    w_hh = torch.cat([r_r, r_u, r_e], dim=0).contiguous()
    return xg, w_hh, torch.zeros_like(bias)


def deepmind_forward(model: DeepMindWaveRNN, d: DeepMindDims, coarse: Tensor,
                     fine: Tensor) -> Tuple[Tensor, Tensor]:
    """Teacher-forced pass over label sequences ``coarse`` / ``fine`` (B, T)
    in [0, 256): step t is predicted from (coarse[t-1], fine[t-1]), the fine
    head also from coarse[t]. Returns (coarse logits, fine logits), each
    (B, T-1, quantisation), aligned with the targets coarse[:, 1:] and
    fine[:, 1:]. The recurrence runs through K4 (``GRUSeqFn`` where a
    gradient is taken, ``gru_seq_fwd`` otherwise)."""
    prev_y = torch.stack([_scale(coarse[:, :-1]), _scale(fine[:, :-1])], dim=-1)
    cur_c = _scale(coarse[:, 1:])[..., None]
    # the input products for the whole sequence, hoisted out of the recurrence
    i_c = model.I_coarse(prev_y)
    i_f = model.I_fine(torch.cat([prev_y, cur_c], dim=-1))
    xg, w_hh, b_hh = _k4_operands(model, i_c, i_f)
    if torch.is_grad_enabled():
        hs = GRUSeqFn.apply(xg, w_hh, b_hh)
    else:
        hs = gru_seq_fwd(xg, w_hh, b_hh)[0]
    h_c, h_f = hs.split(d.split, dim=-1)
    out_c = model.O2(F.relu(model.O1(h_c)))
    out_f = model.O4(F.relu(model.O3(h_f)))
    return out_c, out_f


def deepmind_loss(model: DeepMindWaveRNN, d: DeepMindDims, coarse: Tensor,
                  fine: Tensor) -> Tensor:
    """The sum of both 8-bit heads' mean cross-entropies (the paper's dual
    softmax)."""
    lc, lf = deepmind_forward(model, d, coarse, fine)
    Q = d.quantisation
    return (F.cross_entropy(lc.reshape(-1, Q), coarse[:, 1:].reshape(-1).long())
            + F.cross_entropy(lf.reshape(-1, Q), fine[:, 1:].reshape(-1).long()))


def categorical(logits: Tensor, uniform: Tensor) -> Tensor:
    """A draw from softmax(logits) over the last axis by Gumbel-max:
    argmax(logits + g), g = −log(−log(u)) for ``uniform`` u of logits' shape
    in [0, 1) (u at 0 gives −inf noise, never drawn)."""
    return torch.argmax(logits - torch.log(-torch.log(uniform)), dim=-1)


class _SampleLoop:
    """The sample loop's carried state (h, the previous labels) and one
    block's buffers (its noise, its labels and logits), all allocated once,
    so that a block of steps reads and writes the same memory every time
    and can be captured in a CUDA graph."""

    def __init__(self, model: DeepMindWaveRNN, d: DeepMindDims, batch: int,
                 logits: bool):
        self.model, self.d = model, d
        dev = self.dev = model.R.weight.device
        Q = d.quantisation
        self.hidden = torch.zeros((batch, d.hidden), device=dev)
        self.prev_c = torch.zeros((batch,), device=dev, dtype=torch.long)
        self.prev_f = torch.zeros_like(self.prev_c)
        self.noise = torch.full((STEP_BLOCK, 2, batch, Q), 0.5, device=dev)
        self.cs = torch.zeros((STEP_BLOCK, batch), device=dev, dtype=torch.long)
        self.fs = torch.zeros_like(self.cs)
        self.lcs = torch.zeros((STEP_BLOCK, batch, Q), device=dev) if logits else None
        self.lfs = torch.zeros_like(self.lcs) if logits else None

    def reset(self) -> None:
        for t in (self.hidden, self.prev_c, self.prev_f):
            t.zero_()

    def step(self, i: int) -> None:
        """Step i of the block: one R(hidden) product, the coarse half-step,
        a draw, the fine half-step fed the drawn coarse label, a draw."""
        m, s = self.model, self.d.split
        u_c, u_f = self.noise[i]
        h_c, h_f = self.hidden[:, :s], self.hidden[:, s:]
        prev_y = torch.stack([_scale(self.prev_c), _scale(self.prev_f)], dim=-1)
        r_cu, r_fu, r_cr, r_fr, r_ce, r_fe = F.linear(self.hidden, m.R.weight).split(s, dim=-1)

        i_cu, i_cr, i_ce = m.I_coarse(prev_y).split(s, dim=-1)
        u = torch.sigmoid(r_cu + i_cu + m.bias_u[:s])
        r = torch.sigmoid(r_cr + i_cr + m.bias_r[:s])
        e = torch.tanh(r * r_ce + i_ce + m.bias_e[:s])
        h_c = u * h_c + (1.0 - u) * e
        logits_c = m.O2(F.relu(m.O1(h_c)))
        c_t = categorical(logits_c, u_c)

        fine_in = torch.cat([prev_y, _scale(c_t)[:, None]], dim=-1)
        i_fu, i_fr, i_fe = m.I_fine(fine_in).split(s, dim=-1)
        u = torch.sigmoid(r_fu + i_fu + m.bias_u[s:])
        r = torch.sigmoid(r_fr + i_fr + m.bias_r[s:])
        e = torch.tanh(r * r_fe + i_fe + m.bias_e[s:])
        h_f = u * h_f + (1.0 - u) * e
        logits_f = m.O4(F.relu(m.O3(h_f)))
        f_t = categorical(logits_f, u_f)

        self.hidden.copy_(torch.cat([h_c, h_f], dim=-1))
        self.prev_c.copy_(c_t)
        self.prev_f.copy_(f_t)
        self.cs[i], self.fs[i] = c_t, f_t
        if self.lcs is not None:
            self.lcs[i], self.lfs[i] = logits_c, logits_f

    def run(self, n: int) -> None:
        for i in range(n):
            self.step(i)

    def capture(self) -> "torch.cuda.CUDAGraph":
        """A CUDA graph of a whole block of steps on these buffers: a few
        steps first on a side stream (cuBLAS's first calls outside the
        capture), then the capture, then the state reset to zero."""
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            self.run(3)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.run(STEP_BLOCK)
        self.reset()
        return graph


def deepmind_generate(model: DeepMindWaveRNN, d: DeepMindDims, seq_len: int,
                      batch: int = 1, generator: Optional[torch.Generator] = None,
                      return_logits: bool = False, cuda_graph: bool = True
                      ) -> Tuple[Tensor, ...]:
    """Sample ``batch`` waveforms of ``seq_len`` samples on the model's
    device. Returns (the waveform in [-1, 1], coarse labels, fine labels),
    each (batch, seq_len), and with ``return_logits`` also each step's head
    logits, (batch, seq_len, quantisation) x 2. The noise comes from
    ``generator``, which must live on the model's device (its default
    generator when None), drawn ``STEP_BLOCK`` steps at a time. On the card
    each whole block of steps is one replay of a CUDA graph captured once a
    call (``cuda_graph``; without it the same steps run launch by launch,
    with the same results)."""
    dev = model.R.weight.device
    Q = d.quantisation
    cs = torch.empty((seq_len, batch), device=dev, dtype=torch.long)
    fs = torch.empty_like(cs)
    lcs = torch.empty((seq_len, batch, Q), device=dev) if return_logits else None
    lfs = torch.empty_like(lcs) if return_logits else None
    with torch.no_grad():
        loop = _SampleLoop(model, d, batch, return_logits)
        graph = (loop.capture() if cuda_graph and dev.type == "cuda" and seq_len >= STEP_BLOCK
                 else None)
        for t in range(0, seq_len, STEP_BLOCK):
            n = min(STEP_BLOCK, seq_len - t)
            torch.rand(loop.noise.shape, generator=generator, device=dev, out=loop.noise)
            if graph is not None and n == STEP_BLOCK:
                graph.replay()
            else:
                loop.run(n)
            cs[t:t + n], fs[t:t + n] = loop.cs[:n], loop.fs[:n]
            if return_logits:
                lcs[t:t + n], lfs[t:t + n] = loop.lcs[:n], loop.lfs[:n]
    cs, fs = cs.t(), fs.t()
    wav = combine_signal(cs, fs).float() / 2 ** 15
    if return_logits:
        return wav, cs, fs, lcs.transpose(0, 1), lfs.transpose(0, 1)
    return wav, cs, fs


def generate(model, d: DeepMindDims, seed: int, seq_len: int, batch: int = 1,
             return_logits: bool = False, device=None) -> Tuple[Tensor, ...]:
    """The entry point for sampling (see :func:`deepmind_generate`), the
    noise from a ``torch.Generator`` seeded with ``seed`` on the model's
    device. ``model`` is a :class:`DeepMindWaveRNN`, or its state dict,
    which is loaded into a model built on ``device`` (the card when None;
    RuntimeError without one)."""
    if not isinstance(model, nn.Module):
        from rtvc_tpu_torch.models.factories import empty_on_device

        state = model
        model = empty_on_device(lambda: DeepMindWaveRNN(d), device)
        model.load_state_dict(state, strict=True)
    dev = model.R.weight.device
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    return deepmind_generate(model, d, int(seq_len), int(batch), generator,
                             bool(return_logits))
