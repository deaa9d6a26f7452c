"""The CUDA kernels against their plain PyTorch versions on the card, at
small widths and, for the training kernels, at the trainers' shapes (both
on the GPU, f32; the bf16 instantiations of K3 and K4 on bf16 streams
against their plain bf16 versions, K1's three bf16 (weights, streams) pairs
against their plain versions at the same pair). Every test needs an NVIDIA GPU and
skips without one. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import rel_err
from rtvc_tpu_torch.ops.gru_seq import (
    GRUSeqFn,
    gru_seq_bwd,
    gru_seq_bwd_plain,
    gru_seq_fwd,
    gru_seq_fwd_plain,
)
from rtvc_tpu_torch.ops.lstm_seq import (
    LSTMSeqFn,
    grid_barrier_steps,
    lstm_seq,
    lstm_seq_bwd,
    lstm_seq_bwd_plain,
    lstm_seq_fwd_train,
    lstm_seq_fwd_train_plain,
    lstm_seq_plain,
)
from rtvc_tpu_torch.ops import tacotron_decode as td
from rtvc_tpu_torch.ops import tacotron_train as tk
from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode, tacotron_decode_plain
from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu_torch.ops import audio as taudio
from rtvc_tpu_torch.ops.mel_project import mel_project_normalize, mel_project_normalize_plain
from rtvc_tpu_torch.ops import wavernn_generate as wg
from rtvc_tpu_torch.ops.wavernn_generate import (
    COUNT_NAME,
    LAYERS,
    count_name,
    wavernn_generate_core,
    wavernn_generate_core_plain,
)
from rtvc_tpu_torch.ops.wavernn_generate import plan as k1_plan

pytestmark = pytest.mark.cuda

TACO = dict(
    num_chars=40, n_mels=16, fft_bins=16, speaker_embedding_size=24,
    embed_dims=16, encoder_dims=8, decoder_dims=16, postnet_dims=8,
    encoder_K=2, postnet_K=2, num_highways=2, lstm_dims=16,
    max_r=4, dropout=0.5, stop_threshold=-3.4,
)
VOC = dict(
    variant="runtimeracer-wavernn", mode="RAW", rnn_dims=16, fc_dims=16, bits=6,
    pad=2, upsample_factors=(2, 2, 5), feat_dims=10, compute_dims=8,
    res_out_dims=16, res_blocks=1, hop_length=20, sample_rate=1000,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# small and ragged widths, one row, one step, more rows than SMs, and the
# encoder's inference shape (B 8, T 160, H 768)
@pytest.mark.parametrize("B,T,H", [(3, 20, 128), (2, 9, 40), (8, 160, 768), (1, 7, 128),
                                   (133, 5, 200), (4, 1, 64), (5, 6, 13)])
def test_lstm_seq_kernel_matches_plain(dev, B, T, H):
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w = ((torch.rand(4 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    h0 = torch.randn(B, H, generator=g).to(dev) * 0.5
    c0 = torch.randn(B, H, generator=g).to(dev) * 0.5
    before = _build.launch_counts["lstm_seq"]
    got = lstm_seq(xg, w, h0, c0)
    torch.cuda.synchronize()
    assert _build.launch_counts["lstm_seq"] == before + 1
    for a, b in zip(got, lstm_seq_plain(xg, w, h0, c0)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_lstm_seq_kernel_rejects_bad_input(dev):
    xg = torch.zeros(2, 5, 64, device=dev)
    w = torch.zeros(16, 64, device=dev).t()  # (64, 16) but not contiguous
    h = torch.zeros(2, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_seq(xg, w, h, h)


def test_lstm_seq_kernel_names_its_width_limit(dev):
    B, T, H = 2, 3, 2048  # 16 MB of W_hh: more than the card's shared memory in one piece
    xg = torch.zeros(B, T, 4 * H, device=dev)
    w = torch.zeros(4 * H, H, device=dev)
    h = torch.zeros(B, H, device=dev)
    with pytest.raises(ValueError, match="past the limit of"):
        lstm_seq(xg, w, h, h)
    with pytest.raises(ValueError, match="past the limit of"):
        lstm_seq_bwd(torch.zeros(B, T, H, device=dev), h, h, xg, torch.zeros(B, T, H, device=dev),
                     h, w)


def test_lstm_seq_kernel_widest(dev):
    B, T, H = 9, 3, 1280  # the widest slices: 10 units a CTA
    g = torch.Generator().manual_seed(3)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w = ((torch.rand(4 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    h0, c0, dhT, dcT = (torch.randn(B, H, generator=g).to(dev) * 0.5 for _ in range(4))
    dys = torch.randn(B, T, H, generator=g).to(dev)
    want = lstm_seq_fwd_train_plain(xg, w, h0, c0)
    for a, b in zip(lstm_seq_fwd_train(xg, w, h0, c0), want):
        assert rel_err(a, b) <= 1e-5
    _, _, _, cs, gates = want
    for a, b in zip(lstm_seq_bwd(dys, dhT, dcT, gates, cs, c0, w),
                    lstm_seq_bwd_plain(dys, dhT, dcT, gates, cs, c0, w)):
        assert rel_err(a, b) <= 1e-4


def test_grid_barrier_steps_runs(dev):
    sms, _ = _build.device_limits(dev)
    _counted("grid_barrier_steps", lambda: grid_barrier_steps(sms, 100, dev))


def _counted(name, fn):
    before = _build.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    return out


# small widths, odd widths (the kernels' scalar path), the encoder training
# shape (B 640, T 160, H 768), the inference shape, one row, more rows than
# SMs at a ragged width, and one step
@pytest.mark.parametrize("B,T,H", [(3, 20, 128), (2, 9, 13), (640, 160, 768), (8, 160, 768),
                                   (1, 7, 128), (133, 5, 200), (4, 1, 64)])
def test_lstm_train_kernels_match_plain(dev, B, T, H):
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w = ((torch.rand(4 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    h0, c0, dhT, dcT = (torch.randn(B, H, generator=g).to(dev) * 0.5 for _ in range(4))
    dys = torch.randn(B, T, H, generator=g).to(dev)
    got = _counted("lstm_seq", lambda: lstm_seq_fwd_train(xg, w, h0, c0))
    want = lstm_seq_fwd_train_plain(xg, w, h0, c0)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-5
    ys, hT, cT, cs, gates = want
    got = _counted("lstm_seq_bwd", lambda: lstm_seq_bwd(dys, dhT, dcT, gates, cs, c0, w))
    for a, b in zip(got, lstm_seq_bwd_plain(dys, dhT, dcT, gates, cs, c0, w)):
        assert rel_err(a, b) <= 1e-4
    # no sum goes through an atomic: a second run gives the same bits
    for a, b in zip(got, lstm_seq_bwd(dys, dhT, dcT, gates, cs, c0, w)):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0, c0)]
    torch.autograd.backward(LSTMSeqFn.apply(*leaves), (dys, dhT, dcT))
    ref = [t.clone().requires_grad_() for t in (xg, w, h0, c0)]
    torch.autograd.backward(lstm_seq_plain(*ref), (dys, dhT, dcT))
    for a, b in zip(leaves, ref):
        assert rel_err(a.grad, b.grad) <= 1e-4


# small widths, odd widths (the kernels' scalar path), the three WaveRNN
# training shapes (runtimeracer, fatchord, geneing), one row, more rows than
# SMs at a ragged width, one step, and the CBHG BiGRU's width at its batch;
# then the row-resident mode's (H <= 128) shapes: the clone's postnet CBHG (B 1
# x T 512), the GTA pass's and the ForwardTacotron step's predictors (B 8 and
# 16 x T 160), a DP rank's CBHG (B 56 x T 602), more rows than SMs (B 133 and
# 600: a CTA a row, in waves), one step at H 128, and an odd narrow width;
# then the DeepMind WaveRNN's H 896 (112 slices of 8 units, 7 pieces of 128 a
# row): its training shape (B 40 x T 1000), a few rows, one row, one step
@pytest.mark.parametrize("B,T,H", [(3, 20, 128), (2, 9, 13), (40, 1000, 256), (40, 1000, 512),
                                   (40, 1400, 256), (1, 7, 128), (133, 5, 200), (4, 1, 64),
                                   (112, 50, 64), (5, 6, 13), (1, 512, 64), (8, 160, 64),
                                   (16, 160, 128), (56, 602, 64), (133, 5, 64), (600, 5, 64),
                                   (3, 1, 128), (2, 9, 40), (40, 1000, 896), (4, 50, 896),
                                   (1, 30, 896), (3, 1, 896)])
def test_gru_kernels_match_plain(dev, B, T, H):
    g = torch.Generator().manual_seed(1)
    s = H ** -0.5
    xg = torch.randn(B, T, 3 * H, generator=g).to(dev)
    w = ((torch.rand(3 * H, H, generator=g) - 0.5) * 2 * s).to(dev)
    b = ((torch.rand(3 * H, generator=g) - 0.5) * 2 * s).to(dev)
    dys = torch.randn(B, T, H, generator=g).to(dev)
    got = _counted("gru_seq", lambda: gru_seq_fwd(xg, w, b))
    ys, gates = gru_seq_fwd_plain(xg, w, b)
    assert rel_err(got[0], ys) <= 1e-5 and rel_err(got[1], gates) <= 1e-5
    assert all(torch.equal(a, r) for a, r in zip(got, gru_seq_fwd(xg, w, b)))
    dxg = _counted("gru_seq_bwd", lambda: gru_seq_bwd(dys, gates, ys, w))
    assert rel_err(dxg, gru_seq_bwd_plain(dys, gates, ys, w)) <= 1e-4
    # no sum goes through an atomic: a second run gives the same bits
    assert torch.equal(dxg, gru_seq_bwd(dys, gates, ys, w))
    leaves = [t.clone().requires_grad_() for t in (xg, w, b)]
    GRUSeqFn.apply(*leaves).backward(dys)
    ref = [t.clone().requires_grad_() for t in (xg, w, b)]
    gru_seq_fwd_plain(*ref)[0].backward(dys)
    for a, r in zip(leaves, ref):
        assert rel_err(a.grad, r.grad) <= 1e-4


def _gru_case(dev, B, T, H, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    s = H ** -0.5
    xg = torch.randn(B, T, 3 * H, generator=g).to(dev, dtype)
    w = ((torch.rand(3 * H, H, generator=g) - 0.5) * 2 * s).to(dev, dtype)
    b = ((torch.rand(3 * H, generator=g) - 0.5) * 2 * s).to(dev, dtype)
    dys = torch.randn(B, T, H, generator=g).to(dev, dtype)
    return xg, w, b, dys


def _cooperative_gru(dev, xg, w, b, dys):
    """K4's cooperative kernels on an explicit plan (ys, gates, dxg, dhg),
    the way chip_smoke.py reaches the earlier design at a narrow width."""
    from rtvc_tpu_torch.ops import gru_seq as k4

    B, T, G = xg.shape
    H = G // 3
    limits, elem = _build.device_limits(dev), _build.elem_bytes(xg.dtype)
    ys, gates = (torch.empty(B, T, n * H, device=dev, dtype=xg.dtype) for n in (1, 4))
    k4.launch_fwd(k4.cooperative_plan(B, H, *limits, elem=elem), xg, w, b, ys, gates)
    dxg, dhg = (torch.empty(B, T, 3 * H, device=dev) for _ in range(2))
    k4.launch_bwd(k4.cooperative_plan(B, H, *limits, backward=True, elem=elem), dys, gates, ys,
                  w, dxg, dhg)
    torch.cuda.synchronize()
    return ys, gates, dxg, dhg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(1, 64, 64), (112, 160, 64), (16, 160, 128), (3, 9, 40)])
def test_gru_row_resident_matches_the_cooperative_plan(dev, B, T, H, dtype):
    """At a narrow width the plan is row-resident; its outputs equal the
    earlier cooperative plan's, forced through an explicit plan vector,
    within 1e-5 (f32; bf16 streams within a bf16 rounding of ys and the
    gates, the f32 cotangents within 1e-5 of the cooperative kernel's on the
    same residuals)."""
    from rtvc_tpu_torch.ops import gru_seq as k4
    from rtvc_tpu_torch.ops.gru_seq import _bwd

    limits, elem = _build.device_limits(dev), _build.elem_bytes(dtype)
    for backward in (False, True):
        assert isinstance(k4.plan(B, H, *limits, backward=backward, elem=elem), k4.RowPlan)
    xg, w, b, dys = _gru_case(dev, B, T, H, seed=7, dtype=dtype)
    ys, gates, dxg, dhg = _cooperative_gru(dev, xg, w, b, dys)
    got = gru_seq_fwd(xg, w, b)
    # the backward on the cooperative forward's residuals, so that both see the same inputs
    got_b = _bwd(dys, gates, ys, w)
    torch.cuda.synchronize()
    for a, r in zip(got, (ys, gates)):
        if dtype == torch.float32:
            assert rel_err(a, r) <= 1e-5
        else:
            torch.testing.assert_close(a, r, **BF16)
    for a, r in zip(got_b, (dxg, dhg)):
        assert rel_err(a, r) <= 1e-5


def test_gru_narrow_width_reaches_the_row_resident_kernel(dev, monkeypatch):
    """A CUDA tensor at a narrow width launches the row-resident kernel and
    is counted as K4's launch: the cooperative entry points and the plain
    versions are made to raise, and neither is reached. A plan vector the
    row-resident entry does not take is refused with cudaErrorInvalidValue
    (1), not run another way."""
    from rtvc_tpu_torch.ops import gru_seq as k4

    def refuse(*a, **k):
        raise AssertionError("a narrow-width CUDA call left the row-resident kernel")

    lib = _build.library()
    for name in ("rtvc_gru_seq_fwd", "rtvc_gru_seq_bwd", "rtvc_gru_seq_fwd_bf16",
                 "rtvc_gru_seq_bwd_bf16"):
        monkeypatch.setattr(lib, name, refuse)
    monkeypatch.setattr(k4, "gru_seq_fwd_plain", refuse)
    monkeypatch.setattr(k4, "gru_seq_bwd_plain", refuse)
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        xg, w, b, dys = _gru_case(dev, 4, 9, 64, seed=8, dtype=dtype)
        ys, gates = _counted("gru_seq" + tag, lambda: gru_seq_fwd(xg, w, b))
        _counted("gru_seq_bwd" + tag, lambda: gru_seq_bwd(dys, gates, ys, w))
    xg, w, b, _ = _gru_case(dev, 4, 9, 64, seed=8)
    p = k4.plan(4, 64, *_build.device_limits(dev))
    ys, gates = torch.empty(4, 9, 64, device=dev), torch.empty(4, 9, 256, device=dev)
    for bad in (p._replace(smem=p.smem + 16), p._replace(chunks=4), p._replace(ctas=p.ctas + 1),
                p._replace(lanes=8), p._replace(cluster=2), p._replace(threads=p.threads - 32),
                p._replace(lanes=0), p._replace(cluster=0, ctas=0)):
        assert lib.rtvc_gru_rows_fwd(xg.data_ptr(), w.data_ptr(), b.data_ptr(), ys.data_ptr(),
                                     gates.data_ptr(), 4, 9, 64, _build.int_array(bad),
                                     _build.stream_handle(dev)) == 1


def test_deepmind_forward_on_the_card_reaches_k4_and_matches_the_cpu(dev, monkeypatch):
    """The DeepMind WaveRNN at full width (hidden 896) on the card: its loss,
    the logits and every parameter's gradient within 1e-4 (relative) of the
    CPU route's on the same weights and labels; K4 launched once each way
    under grad and once without, its cooperative plan taken (112 slices of
    8 units), and K4's plain versions never reached."""
    from rtvc_tpu_torch.models import wavernn_deepmind as tdm
    from rtvc_tpu_torch.ops import gru_seq as k4

    d = tdm.DeepMindDims()
    cpu = factories.init_deepmind(d, seed=2, device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        for name in ("bias_u", "bias_r", "bias_e"):
            getattr(cpu, name).uniform_(-0.5, 0.5, generator=g)
    card = factories.init_deepmind(d, device=dev)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    coarse, fine = (torch.randint(0, 256, (3, 41), generator=g) for _ in range(2))
    want_loss = tdm.deepmind_loss(cpu, d, coarse, fine)
    want_loss.backward()
    with torch.no_grad():
        want = tdm.deepmind_forward(cpu, d, coarse, fine)
    p = k4.plan(3, d.hidden, *_build.device_limits(dev))
    assert isinstance(p, k4.Plan) and (p.slices, p.units) == (112, 8)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached K4's plain version")

    monkeypatch.setattr(k4, "gru_seq_fwd_plain", refuse)
    monkeypatch.setattr(k4, "gru_seq_bwd_plain", refuse)
    before = {k: _build.launch_counts[k] for k in ("gru_seq", "gru_seq_bwd")}
    loss = tdm.deepmind_loss(card, d, coarse.to(dev), fine.to(dev))
    loss.backward()
    torch.cuda.synchronize()
    assert {k: _build.launch_counts[k] - before[k] for k in before} == {
        "gru_seq": 1, "gru_seq_bwd": 1}
    assert abs(float(loss.detach()) - float(want_loss.detach())) <= 1e-4 * float(
        want_loss.detach())
    for name, param in card.named_parameters():
        assert rel_err(param.grad.cpu(), dict(cpu.named_parameters())[name].grad) <= 1e-4, name
    with torch.no_grad():
        got = _counted("gru_seq", lambda: tdm.deepmind_forward(card, d, coarse.to(dev),
                                                               fine.to(dev)))
    for a, b in zip(got, want):
        assert rel_err(a.cpu(), b) <= 1e-4


def test_deepmind_generate_on_the_card(dev):
    """The sampling loop on the card at full width: finite labels in range,
    the same seed the same waveform with and without the CUDA graphs, and
    the drawn labels teacher-forced through K4 reproduce the logits they
    were drawn from within 1e-3."""
    from rtvc_tpu_torch.models import wavernn_deepmind as tdm

    d = tdm.DeepMindDims()
    model = factories.init_deepmind(d, seed=5, device=dev)
    n = 2 * tdm.STEP_BLOCK + 44  # two CUDA-graph replays and a block launched step by step
    wav, cs, fs, lcs, lfs = tdm.generate(model, d, 7, seq_len=n, batch=2, return_logits=True)
    again = tdm.generate(model, d, 7, seq_len=n, batch=2)
    eager = tdm.deepmind_generate(model, d, n, 2, torch.Generator(device=dev).manual_seed(7),
                                  cuda_graph=False)
    assert all(torch.equal(a, b) for a, b in zip((wav, cs, fs), again))
    assert all(torch.equal(a, b) for a, b in zip((wav, cs, fs), eager))
    assert wav.is_cuda and wav.shape == (2, n) and float(wav.abs().max()) <= 1.0
    zero = torch.zeros((2, 1), dtype=cs.dtype, device=dev)
    with torch.no_grad():
        lc, lf = _counted("gru_seq", lambda: tdm.deepmind_forward(
            model, d, torch.cat([zero, cs], 1), torch.cat([zero, fs], 1)))
    assert float((lc - lcs).abs().max()) <= 1e-3 and float((lf - lfs).abs().max()) <= 1e-3


def test_gru_seq_kernel_names_its_width_limit(dev):
    B, T, H = 2, 3, 1100  # past 8 units on each of the H100's 132 SMs
    xg = torch.zeros(B, T, 3 * H, device=dev)
    w = torch.zeros(3 * H, H, device=dev)
    b = torch.zeros(3 * H, device=dev)
    with pytest.raises(ValueError, match="past the limit of"):
        gru_seq_fwd(xg, w, b)
    with pytest.raises(ValueError, match="past the limit of"):
        gru_seq_bwd(torch.zeros(B, T, H, device=dev), torch.zeros(B, T, 4 * H, device=dev),
                    torch.zeros(B, T, H, device=dev), w)


# the CBHG BiGRU's shapes: the clone's encoder (B 1 x T 64, its text bucket)
# and postnet (B 1 x T 512, its frame bucket), the Tacotron step's encoder
# (B 112 x T 160) and postnet (B 112 x T 602)
@pytest.mark.parametrize("B,T", [(1, 64), (1, 512), (112, 160), (112, 602)])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_gru_module_on_the_card_matches_its_cpu_route(dev, B, T, with_lengths):
    from rtvc_tpu_torch.models.layers import GRU

    torch.manual_seed(3)
    m = GRU(128, 64, bidirectional=True)
    for p in m.parameters():
        torch.nn.init.uniform_(p, -0.125, 0.125)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(B, T, 128, generator=g)
    dy = torch.randn(B, T, 128, generator=g)
    lengths = (torch.randint(1, T + 1, (B,), generator=g).index_fill_(0, torch.tensor([0]), T)
               if with_lengths else None)
    m_dev = GRU(128, 64, bidirectional=True, device=dev)
    m_dev.load_state_dict(m.state_dict())

    def run(mod, xt, lens):
        mod.zero_grad()
        xt = xt.clone().requires_grad_()
        y, h = mod(xt, lengths=lens)
        y.backward(dy.to(xt.device))
        return [y.detach(), h.detach(), xt.grad] + [p.grad for p in mod.parameters()]

    want = run(m, x, lengths)
    before = {k: _build.launch_counts[k] for k in ("gru_seq", "gru_seq_bwd")}
    got = run(m_dev, x.to(dev), None if lengths is None else lengths.to(dev))
    torch.cuda.synchronize()
    assert {k: _build.launch_counts[k] - before[k] for k in before} == {
        "gru_seq": 2, "gru_seq_bwd": 2}
    for a, b in zip(got, want):
        assert rel_err(a.cpu(), b) <= 1e-4
    with torch.no_grad():
        y_ng = _counted("gru_seq", lambda: m_dev.sequence(x.to(dev)))
        assert rel_err(y_ng.cpu(), m.sequence(x)) <= 1e-4


# ForwardTacotron's generate path at B 1: its BiLSTM (K3, H 512 over a clone's
# 384 mel frames), the predictors' BiGRUs (K4 at H 64 and 128 over the
# 64-character bucket) and the CBHGs' (K4 at H 256 over the text bucket and
# over the frames)
@pytest.mark.parametrize("kernel,T,H", [("lstm_seq", 384, 512), ("gru_seq", 64, 64),
                                        ("gru_seq", 64, 128), ("gru_seq", 64, 256),
                                        ("gru_seq", 384, 256)])
def test_nar_shapes_match_plain(dev, kernel, T, H):
    g = torch.Generator().manual_seed(2)
    n = 4 if kernel == "lstm_seq" else 3
    xg = torch.randn(1, T, n * H, generator=g).to(dev)
    w = ((torch.rand(n * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    if kernel == "lstm_seq":
        h0 = torch.zeros(1, H, device=dev)
        got = _counted(kernel, lambda: lstm_seq(xg, w, h0, h0))
        for a, b in zip(got, lstm_seq_plain(xg, w, h0, h0)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    else:
        b = ((torch.rand(3 * H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
        got = _counted(kernel, lambda: gru_seq_fwd(xg, w, b))
        for a, want in zip(got, gru_seq_fwd_plain(xg, w, b)):
            assert rel_err(a, want) <= 1e-5


# the non-autoregressive trainers' shapes: ForwardTacotron's BiLSTM (K3, H 512)
# over 900 frames at the schedule's first and largest batches, its
# predictors' and prenet's BiGRUs (K4 at H 64, 128 and 256) over 160
# characters and its postnet's (H 256) over the frames
@pytest.mark.parametrize("kernel,B,T,H", [("lstm_seq", 16, 900, 512), ("lstm_seq", 48, 900, 512),
                                          ("gru_seq", 16, 160, 64), ("gru_seq", 16, 160, 128),
                                          ("gru_seq", 16, 160, 256), ("gru_seq", 16, 900, 256)])
def test_nar_training_shapes_match_plain(dev, kernel, B, T, H):
    g = torch.Generator().manual_seed(4)
    n = 4 if kernel == "lstm_seq" else 3
    xg = torch.randn(B, T, n * H, generator=g).to(dev)
    w = ((torch.rand(n * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    dys = torch.randn(B, T, H, generator=g).to(dev)
    if kernel == "lstm_seq":
        h0 = torch.zeros(B, H, device=dev)
        got = _counted("lstm_seq", lambda: lstm_seq_fwd_train(xg, w, h0, h0))
        want = lstm_seq_fwd_train_plain(xg, w, h0, h0)
        for a, b in zip(got, want):
            assert rel_err(a, b) <= 1e-4
        _, _, _, cs, gates = want
        args = (dys, torch.zeros_like(h0), torch.zeros_like(h0), gates, cs, h0, w)
        got = _counted("lstm_seq_bwd", lambda: lstm_seq_bwd(*args))
        for a, b in zip(got, lstm_seq_bwd_plain(*args)):
            assert rel_err(a, b) <= 1e-4
        for a, b in zip(got, lstm_seq_bwd(*args)):
            assert torch.equal(a, b)
    else:
        b = ((torch.rand(3 * H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
        got = _counted("gru_seq", lambda: gru_seq_fwd(xg, w, b))
        ys, gates = gru_seq_fwd_plain(xg, w, b)
        assert rel_err(got[0], ys) <= 1e-4 and rel_err(got[1], gates) <= 1e-4
        dxg = _counted("gru_seq_bwd", lambda: gru_seq_bwd(dys, gates, ys, w))
        assert rel_err(dxg, gru_seq_bwd_plain(dys, gates, ys, w)) <= 1e-4
        assert torch.equal(dxg, gru_seq_bwd(dys, gates, ys, w))


@pytest.mark.parametrize("model_type", ["forward-tacotron", "fast-pitch"])
def test_nar_training_step_on_the_card_matches_its_cpu_route(dev, model_type):
    """One training step of a narrow ForwardTacotron or FastPitch (dropout 0),
    the same weights and batch on the card and on the CPU: the losses within
    1e-4 relative, the updated weights within 1e-5 of the CPU's, and on the
    card ForwardTacotron's BiLSTM through K3 (forward with residuals and
    backward, a launch a direction each) and its five BiGRUs through K4
    (10 launches each way); FastPitch launches neither."""
    from rtvc_tpu_torch.train.steps import make_nar_synth_train_step
    from rtvc_tpu_torch.train.trainer import make_optimizer

    narrow = (dict(embed_dims=16, series_embed_dims=8, duration_conv_dims=12,
                   duration_rnn_dims=8, pitch_conv_dims=12, pitch_rnn_dims=8,
                   energy_conv_dims=12, energy_rnn_dims=8, prenet_dims=16, prenet_k=3,
                   prenet_num_highways=2, rnn_dims=16, postnet_dims=12, postnet_k=3,
                   postnet_num_highways=2, duration_dropout=0.0, pitch_dropout=0.0,
                   energy_dropout=0.0, prenet_dropout=0.0)
              if model_type == "forward-tacotron" else
              dict(embed_dims=16, n_heads=2, conv_dims=24, n_layers_enc=2, n_layers_dec=2,
                   series_d_model=8, series_n_heads=2, series_layers=1, series_d_fft=12,
                   dropout=0.0, series_dropout=0.0))
    cfg = factories.default_config(model_type).replace(**narrow)
    g = torch.Generator().manual_seed(5)
    B, T, L = 4, 32, 64  # durations of 0-2 frames a character
    x_lens = torch.tensor([32, 20, 11, 7])
    chars = torch.where(torch.arange(T)[None, :] < x_lens[:, None],
                        torch.randint(1, 40, (B, T), generator=g), 0)
    durations = torch.where(torch.arange(T)[None, :] < x_lens[:, None],
                            torch.randint(0, 3, (B, T), generator=g), 0).float()
    batch = {"chars": chars, "mels": torch.rand(B, 80, L, generator=g) * 4 - 4,
             "embeds": torch.randn(B, 768, generator=g), "durations": durations,
             "spec_lens": durations.sum(1).long(), "x_lens": x_lens,
             "pitch": torch.rand(B, T, generator=g), "energy": torch.rand(B, T, generator=g)}
    out = {}
    for where in ("cpu", dev):
        model = factories.init_syn_model(model_type, seed=2, override_hp=cfg,
                                         device=where).model.train()
        step = make_nar_synth_train_step(model_type, model, make_optimizer(model.parameters()),
                                         cfg)
        before = dict(_build.launch_counts)
        stats = step({k: v.to(where) for k, v in batch.items()},
                     torch.Generator(device=where).manual_seed(0))
        torch.cuda.synchronize()
        launched = {k: _build.launch_counts[k] - before.get(k, 0)
                    for k in ("lstm_seq", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd")}
        out[str(where)] = (stats, {k: v.cpu() for k, v in model.state_dict().items()}, launched)
    (want, w_state, _), (got, g_state, launched) = out["cpu"], out[str(dev)]
    assert launched == ({"lstm_seq": 2, "lstm_seq_bwd": 2, "gru_seq": 10, "gru_seq_bwd": 10}
                        if model_type == "forward-tacotron" else
                        {"lstm_seq": 0, "lstm_seq_bwd": 0, "gru_seq": 0, "gru_seq_bwd": 0})
    for k in want:
        assert abs(float(got[k]) / float(want[k]) - 1) <= 1e-4, k
    for k, v in w_state.items():
        torch.testing.assert_close(g_state[k], v, atol=1e-5, rtol=0, msg=k)


def test_aligner_on_the_card_matches_its_cpu_route(dev):
    """The alignment pass's Tacotron (narrow, dropout 0) over one utterance
    on the card and on the CPU: the attention within 1e-5, the chain one K5
    forward launch at B 1, r 1, and no backward; a second call on the card
    leaves no tensor behind (autograd keeps no residual under no grad)."""
    from rtvc_tpu_torch.config.synthesizer import TacotronParams
    from rtvc_tpu_torch.inference.attention import TacotronAligner

    cfg = TacotronParams(embed_dims=16, encoder_dims=16, decoder_dims=32, postnet_dims=16,
                         encoder_K=4, lstm_dims=32, postnet_K=4, num_highways=2, dropout=0.0)
    g = torch.Generator().manual_seed(6)
    tokens = torch.randint(1, 60, (37,), generator=g).numpy()
    mel = (torch.rand(80, 301, generator=g) * 8 - 4).numpy()
    embed = torch.randn(768, generator=g).numpy()
    atts = {}
    for where in ("cpu", dev):
        bundle = factories.init_syn_model("tacotron", seed=3, override_hp=cfg, device=where)
        before = dict(_build.launch_counts)
        atts[str(where)] = TacotronAligner(bundle=bundle).attention(tokens, mel, embed)
        launched = {k: _build.launch_counts[k] - before.get(k, 0)
                    for k in ("tacotron_train_fwd", "tacotron_train_bwd")}
    assert launched == {"tacotron_train_fwd": 1, "tacotron_train_bwd": 0}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    TacotronAligner(bundle=bundle).attention(tokens, mel, embed)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated
    assert atts[str(dev)].shape == (301, 37)
    np.testing.assert_allclose(atts[str(dev)], atts["cpu"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("model_type", ["forward-tacotron", "fast-pitch"])
def test_nar_generate_on_the_card_matches_its_cpu_route(dev, model_type):
    """A narrow ForwardTacotron or FastPitch, the same weights on the card
    and on the CPU, two texts: the same durations, the mels within 1e-4,
    and on the card ForwardTacotron's BiLSTM through K3 (a launch a
    direction) and its five BiGRUs through K4 (10 launches); FastPitch
    launches neither."""
    from rtvc_tpu_torch.models import fast_pitch as tfp
    from rtvc_tpu_torch.models import forward_tacotron as tft

    narrow = (dict(embed_dims=16, series_embed_dims=8, duration_conv_dims=12,
                   duration_rnn_dims=8, pitch_conv_dims=12, pitch_rnn_dims=8,
                   energy_conv_dims=12, energy_rnn_dims=8, prenet_dims=16, prenet_k=3,
                   prenet_num_highways=2, rnn_dims=16, postnet_dims=12, postnet_k=3,
                   postnet_num_highways=2)
              if model_type == "forward-tacotron" else
              dict(embed_dims=16, n_heads=2, conv_dims=24, n_layers_enc=2, n_layers_dec=2,
                   series_d_model=8, series_n_heads=2, series_layers=1, series_d_fft=12))
    cfg = factories.default_config(model_type).replace(**narrow)
    cpu = factories.init_syn_model(model_type, seed=1, override_hp=cfg, device="cpu").model
    card = factories.init_syn_model(model_type, seed=1, override_hp=cfg, device=dev).model
    with torch.no_grad():
        cpu.dur_pred.lin.bias.fill_(3.0)
        card.dur_pred.lin.bias.fill_(3.0)
    gen = tft.forward_generate if model_type == "forward-tacotron" else tfp.fastpitch_generate
    g = torch.Generator().manual_seed(3)
    chars = torch.randint(1, 40, (2, 32), generator=g)
    chars[1, 20:] = 0
    spk = torch.randn(2, 768, generator=g)
    want_mel, want_durs = gen(cpu, chars, spk)
    before = {k: _build.launch_counts[k] for k in ("lstm_seq", "gru_seq")}
    got_mel, got_durs = gen(card, chars.to(dev), spk.to(dev))
    torch.cuda.synchronize()
    launched = {k: _build.launch_counts[k] - before[k] for k in before}
    assert launched == ({"lstm_seq": 2, "gru_seq": 10} if model_type == "forward-tacotron"
                        else {"lstm_seq": 0, "gru_seq": 0})
    assert np.array_equal(got_durs, want_durs)
    torch.testing.assert_close(got_mel.cpu(), want_mel, atol=1e-4, rtol=0)


def test_de_emphasis_on_the_card_matches_its_cpu_route(dev):
    """``inv_preemphasis`` on the card (the blocked IIR, no host sync) gives
    the CPU route's samples (scipy's ``lfilter``) within f32 rounding."""
    from rtvc_tpu_torch.ops import audio as taudio

    x = torch.randn(76600, generator=torch.Generator().manual_seed(6)) * 0.3
    want = taudio.inv_preemphasis(x, 0.97)
    got = taudio.inv_preemphasis(x.to(dev), 0.97)
    assert got.is_cuda and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=1e-6)


def test_train_kernels_reject_bad_input(dev):
    h = torch.zeros(2, 16, device=dev)
    with pytest.raises(ValueError, match="w_hh"):
        lstm_seq_bwd(torch.zeros(2, 5, 16, device=dev), h, h,
                     torch.zeros(2, 5, 64, device=dev), torch.zeros(2, 5, 16, device=dev),
                     h, torch.zeros(64, 15, device=dev))
    with pytest.raises(ValueError, match="f32"):
        gru_seq_fwd(torch.zeros(2, 5, 48, device=dev, dtype=torch.float64),
                    torch.zeros(48, 16, device=dev), torch.zeros(48, device=dev))


# The bf16 instantiations (the bf16 training policy's streams, f32 state):
# each at a ragged width and at a trainer's shape, against its plain bf16
# version on the same inputs. The bf16 outputs are held within
# torch.testing's bf16 defaults (the tolerance the CPU tests hold the plain
# versions to against the JAX package: sums in another order may put an f32
# value on the other side of a bf16 rounding boundary), the f32 outputs
# within 1e-4 of their largest entry, as the f32 kernels are.
BF16 = dict(rtol=1.6e-2, atol=1e-5)


def _launches(name):
    return _build.launch_counts.get(name, 0)


@pytest.mark.parametrize("B,T,H", [(3, 20, 40), (640, 160, 768)])
def test_lstm_bf16_kernels_match_plain(dev, B, T, H):
    g = torch.Generator().manual_seed(3)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev, torch.bfloat16)
    w = ((torch.rand(4 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev, torch.bfloat16)
    h0, c0, dhT, dcT = (torch.randn(B, H, generator=g).to(dev) * 0.5 for _ in range(4))
    dys = torch.randn(B, T, H, generator=g).to(dev, torch.bfloat16)
    before = (_launches("lstm_seq_bf16"), _launches("lstm_seq"))
    got = lstm_seq_fwd_train(xg, w, h0, c0)
    assert (_launches("lstm_seq_bf16"), _launches("lstm_seq")) == (before[0] + 1, before[1])
    want = lstm_seq_fwd_train_plain(xg, w, h0, c0)
    for i in (0, 3, 4):
        assert got[i].dtype == torch.bfloat16
        torch.testing.assert_close(got[i], want[i], **BF16)
    for i in (1, 2):
        assert got[i].dtype == torch.float32 and rel_err(got[i], want[i]) <= 1e-4
    args = (dys, dhT, dcT, want[4], want[3], c0, w)
    before = (_launches("lstm_seq_bwd_bf16"), _launches("lstm_seq_bwd"))
    k = lstm_seq_bwd(*args)
    assert (_launches("lstm_seq_bwd_bf16"), _launches("lstm_seq_bwd")) == (before[0] + 1,
                                                                          before[1])
    for a, b in zip(k, lstm_seq_bwd_plain(*args)):
        assert a.dtype == torch.float32 and rel_err(a, b) <= 1e-4


def _lstm_bf16_inputs(dev, B, T, H, seed):
    g = torch.Generator().manual_seed(seed)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev, torch.bfloat16)
    w = ((torch.rand(4 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev, torch.bfloat16)
    h0, c0, dhT, dcT = (torch.randn(B, H, generator=g).to(dev) * 0.5 for _ in range(4))
    dys = torch.randn(B, T, H, generator=g).to(dev, torch.bfloat16)
    return xg, w, h0, c0, dhT, dcT, dys


# K3's tensor-core mode (csrc/lstm_seq_mma.cu) where the plan names it: the
# GE2E step's B 640 x 160 x 768; B 130 x 768, whose last 64-row tile holds
# 2 rows; ForwardTacotron's H 512 at B 48 (both directions) and B 16 (the
# backward; the forward stays on the CUDA-core design below the threshold);
# one step (T 1) at H 384, K-groups of 2.
@pytest.mark.parametrize("B,T,H", [(640, 160, 768), (130, 20, 768), (48, 50, 512),
                                   (16, 30, 512), (64, 1, 384)])
def test_lstm_bf16_tensor_core_mode_matches_plain(dev, B, T, H):
    from rtvc_tpu_torch.ops import lstm_seq as k3

    limits = _build.device_limits(dev)
    pf = k3.plan(B, H, *limits, elem=2)
    pb = k3.plan(B, H, *limits, backward=True, elem=2)
    assert isinstance(pb, k3.MmaPlan)
    assert isinstance(pf, k3.MmaPlan) == (B >= k3.MMA_MIN_ROWS[0])
    xg, w, h0, c0, dhT, dcT, dys = _lstm_bf16_inputs(dev, B, T, H, 6)
    before = (_launches("lstm_seq_bf16"), _launches("lstm_seq"))
    got = lstm_seq_fwd_train(xg, w, h0, c0)
    assert (_launches("lstm_seq_bf16"), _launches("lstm_seq")) == (before[0] + 1, before[1])
    want = lstm_seq_fwd_train_plain(xg, w, h0, c0)
    for i in (0, 3, 4):
        assert got[i].dtype == torch.bfloat16
        torch.testing.assert_close(got[i], want[i], **BF16)
    for i in (1, 2):
        assert got[i].dtype == torch.float32 and rel_err(got[i], want[i]) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, lstm_seq_fwd_train(xg, w, h0, c0)))
    # the inference forward, which writes no residuals, gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(lstm_seq(xg, w, h0, c0), got[:3]))
    args = (dys, dhT, dcT, want[4], want[3], c0, w)
    before = (_launches("lstm_seq_bwd_bf16"), _launches("lstm_seq_bwd"))
    k = lstm_seq_bwd(*args)
    assert (_launches("lstm_seq_bwd_bf16"), _launches("lstm_seq_bwd")) == (before[0] + 1,
                                                                          before[1])
    for a, b in zip(k, lstm_seq_bwd_plain(*args)):
        assert a.dtype == torch.float32 and rel_err(a, b) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(k, lstm_seq_bwd(*args)))


def test_lstm_tensor_core_entries_refuse_a_plan_they_do_not_take(dev):
    """The tensor-core entry points check the plan they are given: one with
    no instantiation, a shared-memory size that is not the W slice's, a
    group of rows past B, or a K-group the backward has no instantiation
    for (3 at H 384) or that does not divide the slices (5) returns
    cudaErrorInvalidValue (1), which the wrapper raises; nothing runs the
    other design instead."""
    from rtvc_tpu_torch.ops import lstm_seq as k3

    B, T, H = 64, 4, 384
    limits = _build.device_limits(dev)
    xg, w, h0, c0, dhT, dcT, dys = _lstm_bf16_inputs(dev, B, T, H, 7)
    outs = [torch.empty(B, T, H, device=dev, dtype=torch.bfloat16), torch.empty(B, H, device=dev),
            torch.empty(B, H, device=dev), torch.empty(B, T, H, device=dev, dtype=torch.bfloat16),
            torch.empty(B, T, 4 * H, device=dev, dtype=torch.bfloat16)]
    grads = [torch.empty(B, T, 4 * H, device=dev), torch.empty(B, H, device=dev),
             torch.empty(B, H, device=dev)]
    pf, pb = k3.mma_plan(B, H, *limits), k3.mma_plan(B, H, *limits, backward=True)
    k3.launch_fwd(pf, xg, w, h0, c0, *outs)
    args = (dys, dhT, dcT, outs[4], outs[3], c0, w)
    k3.launch_bwd(pb, *args, *grads)
    torch.cuda.synchronize()
    for bad in (pf._replace(units=16, slices=H // 16, smem=8 * 16 * H),
                pf._replace(smem=pf.smem + 16), pf._replace(groups=pf.groups + 1),
                pf._replace(kgroup=2)):
        with pytest.raises(RuntimeError, match="rtvc_lstm_mma_fwd_bf16.*cudaError_t 1$"):
            k3.launch_fwd(bad, xg, w, h0, c0, *outs)
    for bad in (pb._replace(kgroup=3), pb._replace(kgroup=5), pb._replace(smem=pb.smem - 2)):
        with pytest.raises(RuntimeError, match="rtvc_lstm_mma_bwd_bf16.*cudaError_t 1$"):
            k3.launch_bwd(bad, *args, *grads)


@pytest.mark.parametrize("B,T,H", [(3, 20, 40), (112, 602, 64), (1, 512, 64), (16, 160, 64),
                                   (16, 160, 128), (2, 9, 13)])
def test_gru_bf16_kernels_match_plain(dev, B, T, H):
    g = torch.Generator().manual_seed(4)
    xg = torch.randn(B, T, 3 * H, generator=g).to(dev, torch.bfloat16)
    w = ((torch.rand(3 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev, torch.bfloat16)
    b = ((torch.rand(3 * H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev, torch.bfloat16)
    dys = torch.randn(B, T, H, generator=g).to(dev, torch.bfloat16)
    before = (_launches("gru_seq_bf16"), _launches("gru_seq"))
    ys, gates = gru_seq_fwd(xg, w, b)
    assert (_launches("gru_seq_bf16"), _launches("gru_seq")) == (before[0] + 1, before[1])
    p_ys, p_gates = gru_seq_fwd_plain(xg, w, b)
    for a, want in ((ys, p_ys), (gates, p_gates)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, want, **BF16)
    before = (_launches("gru_seq_bwd_bf16"), _launches("gru_seq_bwd"))
    dxg = gru_seq_bwd(dys, p_gates, p_ys, w)
    assert (_launches("gru_seq_bwd_bf16"), _launches("gru_seq_bwd")) == (before[0] + 1,
                                                                        before[1])
    assert dxg.dtype == torch.float32
    assert rel_err(dxg, gru_seq_bwd_plain(dys, p_gates, p_ys, w)) <= 1e-4
    # the autograd functions return each cotangent in its input's dtype
    leaves = [t.clone().requires_grad_() for t in (xg, w, b)]
    GRUSeqFn.apply(*leaves).backward(dys)
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] * 3


def test_bf16_tensors_reach_the_bf16_kernel_or_raise(dev, monkeypatch):
    """A bf16 CUDA tensor launches the bf16 instantiation: never the f32
    kernel (nothing widens it) and never the plain version (which raises
    here); a call that mixes bf16 and f32 streams raises."""
    from rtvc_tpu_torch.ops import gru_seq as k4
    from rtvc_tpu_torch.ops import lstm_seq as k3

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, names in ((k3, ("lstm_seq_plain", "lstm_seq_fwd_train_plain", "lstm_seq_bwd_plain")),
                       (k4, ("gru_seq_fwd_plain", "gru_seq_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    B, T, H = 4, 9, 32
    g = torch.Generator().manual_seed(5)
    bf = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
    h = torch.zeros(B, H, device=dev)
    _build.launch_counts.clear()
    xg, w = bf(B, T, 4 * H).requires_grad_(), (bf(4 * H, H) * 0.1).requires_grad_()
    ys, _, _ = k3.LSTMSeqFn.apply(xg, w, h, h)
    ys.float().sum().backward()
    with torch.no_grad():
        k3.lstm_seq(xg, w, h, h)
    x3, w3, b3 = (bf(B, T, 3 * H).requires_grad_(), (bf(3 * H, H) * 0.1).requires_grad_(),
                  bf(3 * H).requires_grad_())
    k4.GRUSeqFn.apply(x3, w3, b3).float().sum().backward()
    assert dict(_build.launch_counts) == {"lstm_seq_bf16": 2, "lstm_seq_bwd_bf16": 1,
                                          "gru_seq_bf16": 1, "gru_seq_bwd_bf16": 1}
    with pytest.raises(ValueError, match="w_hh"):  # bf16 streams, an f32 W_hh
        k3.lstm_seq(xg.detach(), w.detach().float(), h, h)
    with pytest.raises(ValueError, match="h0"):  # the state stays f32
        k3.lstm_seq(xg.detach(), w.detach(), h.bfloat16(), h)
    with pytest.raises(ValueError, match="b_hh"):
        k4.gru_seq_fwd(x3.detach(), w3.detach(), b3.detach().float())


def _taco(dev, B, T=16, max_r=4):
    d = tt.TacotronDims(**{**TACO, "max_r": max_r})
    model = factories.init_tacotron(d, seed=0, device=dev)
    g = torch.Generator().manual_seed(1)
    chars = torch.randint(1, 40, (B, T), generator=g)
    chars[:, max(1, T - 4):] = 0
    spk = torch.randn(B, 24, generator=g)
    with torch.no_grad():
        seq, proj = tt.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)
    mask = (chars != 0).float().to(dev)
    return model, d, seq.contiguous(), proj.contiguous(), mask


# one row to more rows than a 32-row pass, one character to more than a warp
# of them, and r from 1 to beyond a row block of mel frames
@pytest.mark.parametrize("r", [1, 2, 7])
@pytest.mark.parametrize("T", [1, 33, 200])
@pytest.mark.parametrize("B", [1, 2, 11, 24, 33])
def test_tacotron_decode_kernel_matches_plain(dev, B, T, r):
    model, d, seq, proj, mask = _taco(dev, B, T, max_r=7)
    with torch.no_grad():
        km, ka, ks = _counted("tacotron_decode", lambda: tacotron_decode(
            model, d, seq, proj, mask, 0, r, 40, dropout=False))
        pm, pa, ps = tacotron_decode_plain(model, d, seq, proj, mask, 0, r, 40,
                                           dropout=False)
    torch.cuda.synchronize()
    assert tt.stop_iterations(ks, r) == tt.stop_iterations(ps, r)
    torch.testing.assert_close(km, pm, atol=1e-4, rtol=0)
    torch.testing.assert_close(ka, pa, atol=1e-5, rtol=0)
    torch.testing.assert_close(ks, ps, atol=1e-4, rtol=0)


def test_tacotron_decode_kernel_full_width(dev):
    """The synthesizer's default widths at its batch of 24 and a 160-character
    bucket, over 8 iterations: the weights resident, 8 rows an item."""
    cfg = factories.default_config(factories.MODEL_TYPE_TACOTRON).replace(max_decoder_steps=16)
    syn = factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=0, override_hp=cfg,
                                   device=dev)
    d, model = syn.dims, syn.model
    B, T = 24, 160
    g = torch.Generator().manual_seed(3)
    chars = torch.randint(1, d.num_chars, (B, T), generator=g)
    for b in range(B):
        chars[b, T - 3 * b:] = 0
    spk = torch.nn.functional.normalize(torch.randn(B, d.speaker_embedding_size, generator=g))
    with torch.no_grad():
        seq, proj = tt.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)
        seq, proj, mask = seq.contiguous(), proj.contiguous(), (chars != 0).float().to(dev)
        p = td.plan(B, T, td.DecoderShape.of(model, d), 2, *_build.device_limits(dev))
        assert p.resident == 1 and p.nb == 8
        km, ka, ks = tacotron_decode(model, d, seq, proj, mask, 0, 2, 16, dropout=False)
        pm, pa, ps = tacotron_decode_plain(model, d, seq, proj, mask, 0, 2, 16, dropout=False)
    torch.cuda.synchronize()
    assert tt.stop_iterations(ks, 2) == tt.stop_iterations(ps, 2) == 8
    torch.testing.assert_close(km, pm, atol=1e-4, rtol=0)
    torch.testing.assert_close(ka, pa, atol=1e-5, rtol=0)


def test_tacotron_decode_kernel_stops_and_zeroes(dev):
    model, d, seq, proj, mask = _taco(dev, 3)
    with torch.no_grad():
        model.decoder.stop_proj.bias.fill_(30.0)
        mel, attn, stops = tacotron_decode(model, d, seq, proj, mask, 0, 2, 40,
                                           dropout=False)
    n = tt.stop_iterations(stops, 2)
    assert n == 7
    assert mel[:, :, 2 * n:].abs().max() == 0 and attn[:, n:].abs().max() == 0
    assert (stops[:, n:] == 0).all()


def test_tacotron_decode_kernel_dropout_is_seeded(dev):
    model, d, seq, proj, mask = _taco(dev, 2)

    def run(seed):
        with torch.no_grad():
            return tacotron_decode(model, d, seq, proj, mask, seed, 2, 24)[0]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_tacotron_decode_kernel_dropout_equal_across_plans(dev):
    """The dropout mask depends on (seed, iteration, row, unit) only: a plan
    with the weights read from L2 and 4 rows an item gives the bits of the
    resident plan with 2 rows an item."""
    model, d, seq, proj, mask = _taco(dev, 2)
    s = td.DecoderShape.of(model, d)
    limits = _build.device_limits(dev)
    plans = [td.plan(2, 16, s, 2, *limits, resident=1, nb=2),
             td.plan(2, 16, s, 2, *limits, resident=0, nb=4)]
    assert plans[0].ks == plans[1].ks and plans[0] != plans[1]
    with torch.no_grad():
        a, b = (td.launch(_build.library(), model, d, seq, proj, mask, 5, 2, 24, True, p)[0]
                for p in plans)
    assert torch.equal(a, b)


def test_tacotron_decode_kernel_refuses_what_does_not_fit(dev):
    model, d, seq, proj, mask = _taco(dev, 2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="outside"):
            tacotron_decode(model, d, seq, proj, mask, 0, 5, 24)
        p = td.plan(2, 16, td.DecoderShape.of(model, d), 2, *_build.device_limits(dev))
        too_many = p._replace(ctas=8 * _build.device_limits(dev)[0])
        with pytest.raises(RuntimeError, match="rtvc_tacotron_decode"):
            td.launch(_build.library(), model, d, seq, proj, mask, 0, 2, 24, False, too_many)
        model.decoder.attn_net = tt.LSA(d, filters=33, device=dev)
        with pytest.raises(ValueError, match="past the limit of 32"):
            tacotron_decode(model, d, seq, proj, mask, 0, 2, 24)


def _chunked(model, d, seq, proj, mask, seed, r, cuts, dropout, min_iters=0, pad=-4.0):
    """A decode cut into launches of ``cuts`` iterations, each resumed from
    the last one's carry: [(its inputs (carry, prev, done, start, n), its
    DecodeChunk)]."""
    B, T = mask.shape
    carry = tt.init_decoder_carry(d, B, T, device=mask.device)
    prev = torch.zeros(B, d.n_mels, device=mask.device)
    done = torch.zeros((), dtype=torch.int32, device=mask.device)
    outs, start = [], 0
    with torch.no_grad():
        for n in cuts:
            out = _counted("tacotron_decode_chunk", lambda: td.tacotron_decode_chunk(
                model, d, seq, proj, mask, seed, r, carry, prev, done, start, n, min_iters,
                pad, dropout))
            outs.append(((carry, prev, done, start, n), out))
            carry, prev, done, start = out.carry, out.prev, out.done, start + n
    return outs


def _state(out):
    return (*out.carry, out.prev)


@pytest.mark.parametrize("B,T", [(1, 16), (3, 33), (24, 40)])
def test_tacotron_decode_chunks_equal_one_launch(dev, B, T):
    """With dropout on, the chunks of a decode joined give one launch's bits
    (mel, attention, stops, the final carry); the whole-utterance launch is
    the zero-carry case of the same kernel."""
    model, d, seq, proj, mask = _taco(dev, B, T)
    [(_, one)] = _chunked(model, d, seq, proj, mask, 9, 2, [20], True)
    parts = [out for _, out in _chunked(model, d, seq, proj, mask, 9, 2, [3, 5, 5, 7], True)]
    for name in ("mel", "attn", "stops"):
        dim = 2 if name == "mel" else 1
        assert torch.equal(torch.cat([getattr(o, name) for o in parts], dim), getattr(one, name))
    for a, b in zip(_state(parts[-1]), _state(one)):
        assert torch.equal(a, b)
    assert int(parts[-1].done) == int(one.done)
    assert sum(int(o.valid) for o in parts) == int(one.valid)
    [(_, zero_pad)] = _chunked(model, d, seq, proj, mask, 9, 2, [20], True, pad=0.0)
    with torch.no_grad():
        whole = tacotron_decode(model, d, seq, proj, mask, 9, 2, 40)
    for a, b in zip(whole, (zero_pad.mel, zero_pad.attn, zero_pad.stops)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,T", [(1, 16), (3, 33)])
def test_tacotron_decode_chunk_matches_plain_from_a_carry(dev, B, T):
    """Dropout off: each launch against the plain loop from the carry it
    was given: mel within 1e-6, attention and the carry out within 1e-6,
    the same stop."""
    model, d, seq, proj, mask = _taco(dev, B, T)
    for (carry, prev, done, start, n), out in _chunked(model, d, seq, proj, mask, 0, 2,
                                                       [3, 5, 5, 7], False):
        with torch.no_grad():
            ref = td.tacotron_decode_chunk_plain(model, d, seq, proj, mask, 0, 2, carry, prev,
                                                 done, start, n, 0, -4.0, False)
        assert int(out.valid) == int(ref.valid) and int(out.done) == int(ref.done)
        torch.testing.assert_close(out.mel, ref.mel, atol=1e-6, rtol=0)
        torch.testing.assert_close(out.attn, ref.attn, atol=1e-6, rtol=0)
        for a, b in zip(_state(out), _state(ref)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("min_iters,cut,valid", [(0, 1, 3), (9, 2, 2)])
def test_tacotron_decode_chunk_stops_mid_chunk(dev, min_iters, cut, valid):
    """Every stop token fires: at iteration 6 (the first past step 10 at r
    2), or at ``min_iters``. The launch that holds it runs ``valid``
    iterations, writes the pad after them and carries the state of the stop
    iteration out; the next launch writes only the pad."""
    model, d, seq, proj, mask = _taco(dev, 2)
    with torch.no_grad():
        model.decoder.stop_proj.bias.fill_(30.0)
    outs = _chunked(model, d, seq, proj, mask, 0, 2, [4, 4, 4, 4], False, min_iters)
    (carry, prev, done, start, n), out = outs[cut]
    with torch.no_grad():
        ref = td.tacotron_decode_chunk_plain(model, d, seq, proj, mask, 0, 2, carry, prev, done,
                                             start, n, min_iters, -4.0, False)
    assert int(out.valid) == int(ref.valid) == valid and int(out.done) == int(ref.done) == 1
    assert (out.mel[:, :, 2 * valid:] == -4.0).all() and (out.stops[:, valid:] == 0).all()
    torch.testing.assert_close(out.mel, ref.mel, atol=1e-6, rtol=0)
    for a, b in zip(_state(out), _state(ref)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert all(int(o.valid) == 4 and int(o.done) == 0 for _, o in outs[:cut])
    for (carry, prev, _, _, _), after in outs[cut + 1:]:
        assert int(after.valid) == 0 and int(after.done) == 1
        assert (after.mel == -4.0).all()
        assert all(torch.equal(a, b) for a, b in zip(_state(after), (*carry, prev)))


def test_tacotron_decode_chunk_after_the_stop_writes_the_pad(dev):
    """A ``done`` carried in: no iteration runs, the mel is the pad, the
    attention and the stops zero, and the carry comes back as it went in."""
    model, d, seq, proj, mask = _taco(dev, 3)
    [((_, _, _, _, _), first)] = _chunked(model, d, seq, proj, mask, 0, 2, [5], False)
    with torch.no_grad():
        out = td.tacotron_decode_chunk(model, d, seq, proj, mask, 0, 2, first.carry, first.prev,
                                       torch.ones((), dtype=torch.int32, device=dev), 5, 6, 0,
                                       -4.0, False)
    assert int(out.valid) == 0 and int(out.done) == 1
    assert (out.mel == -4.0).all() and (out.attn == 0).all() and (out.stops == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(_state(out), _state(first)))


def _voc(dev, B=3, T=300, variant="runtimeracer-wavernn", mode="RAW"):
    d = tw.WaveRNNDims(**{**VOC, "variant": variant, "mode": mode})
    model = factories.init_wavernn(d, seed=0, device=dev)
    g = torch.Generator().manual_seed(2)
    mels = (torch.rand(1, 10, 14, generator=g) * 2 - 1).to(dev)
    with torch.no_grad():
        mu, aux, _ = tw.upsample_forward(model, d, mels)
        mu = mu.repeat(B, 2, 1)[:, :T].contiguous()
        aux = aux.repeat(B, 2, 1)[:, :T].contiguous()
        streams = {k: v.contiguous() for k, v in tw.hoist_aux(model, d, mu, aux).items()}
    return tw.step_weights(model, d), streams, d


def test_wavernn_kernel_greedy_matches_plain(dev):
    w, s, d = _voc(dev)
    got, k_logits = wavernn_generate_core(w, s, 0, argmax=True, return_logits=True)
    ref, p_logits = wavernn_generate_core_plain(w, s, 0, argmax=True, return_logits=True)
    C = d.n_classes
    assert torch.equal(torch.round((got + 1) * (C - 1) / 2), torch.round((ref + 1) * (C - 1) / 2))
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(k_logits, p_logits, atol=1e-5, rtol=0)


def test_wavernn_kernel_sampler_distribution(dev):
    w, s, d = _voc(dev, B=8, T=500)
    C = d.n_classes
    logits = torch.randn(C, generator=torch.Generator().manual_seed(3)) * 1.5
    w["fc5_w"] = torch.zeros_like(w["fc5_w"])
    w["fc5_b"] = logits.to(dev)
    samples = wavernn_generate_core(w, s, seed=12345)
    labels = torch.round((samples.reshape(-1) + 1) * (C - 1) / 2).long().cpu().numpy()
    p = torch.softmax(logits.double(), 0).numpy()
    expected = p * labels.size
    counts = np.bincount(labels, minlength=C)
    keep = expected >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    assert stats.chisquare(obs, exp).pvalue > 1e-3
    again = wavernn_generate_core(w, s, seed=12345)
    assert torch.equal(samples, again)


CELLS = [("fatchord-wavernn", "RAW"), ("fatchord-wavernn", "MOL"), ("geneing-wavernn", "BITS"),
         ("geneing-wavernn", "RAW"), ("geneing-wavernn", "MOL"),
         ("runtimeracer-wavernn", "RAW"), ("runtimeracer-wavernn", "MOL")]


@pytest.mark.parametrize("B", [1, 13, 264])
@pytest.mark.parametrize("variant,mode", CELLS)
def test_wavernn_kernel_cells_greedy_match_plain(dev, variant, mode, B):
    """Every variant x head cell at a small width, at one fold, at the 5 s
    clone's 13 and past the SM count: the head's inputs within 1e-5 at every
    step, the samples within 1e-6 (categorical: equal labels) or 1e-5 (MOL
    and beta feed a continuous sample back)."""
    w, s, d = _voc(dev, B=B, T=300 if B < 100 else 60, variant=variant, mode=mode)
    last = LAYERS[variant].fcs[-1].name
    # a wide last FC, so that the greedy decode moves
    w[f"{last}_w"] = (torch.randn(w[f"{last}_w"].shape,
                                  generator=torch.Generator().manual_seed(6)) * 2.0).to(dev)
    kw = dict(variant=variant, head=d.head)
    got, k_logits = _counted(COUNT_NAME[variant], lambda: wavernn_generate_core(
        w, s, 0, argmax=True, return_logits=True, **kw))
    ref, p_logits = wavernn_generate_core_plain(w, s, 0, argmax=True, return_logits=True, **kw)
    assert float(p_logits.std(dim=1).max()) > 1e-3  # the head's inputs move with the step
    torch.testing.assert_close(k_logits, p_logits, atol=1e-5, rtol=0)
    if d.head == "categorical":
        C = d.n_classes
        assert torch.equal(torch.round((got + 1) * (C - 1) / 2),
                           torch.round((ref + 1) * (C - 1) / 2))
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    else:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant,mode", [("fatchord-wavernn", "MOL"), ("geneing-wavernn", "RAW"),
                                          ("geneing-wavernn", "BITS")])
def test_wavernn_kernel_heads_sample_their_distribution(dev, variant, mode):
    w, s, d = _voc(dev, B=8, T=2000, variant=variant, mode=mode)
    C = d.n_classes
    rng = np.random.default_rng(4)
    if d.head == "mol":
        logit, mean = rng.normal(0, 1, 10), rng.uniform(-0.6, 0.6, 10)
        log_scale = rng.uniform(-4.5, -3.5, 10)
        bias = np.concatenate([logit, mean, log_scale])
    elif d.head == "beta":
        bias = np.log([0.7, 3.0])  # alpha < 1: the boosted gamma draw
    else:
        bias = rng.normal(0, 1.5, C)
    last = LAYERS[variant].fcs[-1].name
    w[f"{last}_w"] = torch.zeros_like(w[f"{last}_w"])
    w[f"{last}_b"] = torch.tensor(bias, dtype=torch.float32, device=dev)
    kw = dict(variant=variant, head=d.head)
    samples = wavernn_generate_core(w, s, seed=99, **kw)
    # one seed gives equal bits
    assert torch.equal(samples, wavernn_generate_core(w, s, seed=99, **kw))
    assert not torch.equal(samples, wavernn_generate_core(w, s, seed=100, **kw))
    x = samples.reshape(-1).double().cpu().numpy()
    assert np.isfinite(x).all() and np.abs(x).max() <= 1.0
    if d.head == "mol":
        pi = np.exp(logit - logit.max())
        pi /= pi.sum()

        def cdf(v):
            z = (np.asarray(v)[..., None] - mean) / np.exp(log_scale)
            return (pi / (1.0 + np.exp(-z))).sum(-1)

        assert stats.kstest(x, cdf).pvalue > 1e-3
    elif d.head == "beta":
        assert stats.kstest((x + 1) / 2, stats.beta(0.7, 3.0).cdf).pvalue > 1e-3
    else:
        labels = np.rint((x + 1) * (C - 1) / 2).astype(np.int64)
        p = np.exp(bias - bias.max())
        expected = p / p.sum() * labels.size
        counts = np.bincount(labels, minlength=C)
        keep = expected >= 5
        obs = np.append(counts[keep], counts[~keep].sum())
        exp = np.append(expected[keep], expected[~keep].sum())
        assert stats.chisquare(obs, exp).pvalue > 1e-3


def _full_width_greedy(dev, variant, mode, B, T):
    """A cell at its config's default widths (the plan's real cut of the
    layers over the card), B folds x T steps, greedy: head inputs within
    1e-4 and the same samples as the plain version (categorical: labels).
    Returns the vocoder's dims."""
    from rtvc_tpu_torch.models import wavernn as wrn

    cfg = factories.default_config(variant).replace(mode=mode)
    voc = factories.init_voc_model(variant, seed=0, override_hp=cfg, device=dev)
    d, model = voc.dims, voc.model
    g = torch.Generator().manual_seed(8)
    mels_up = (torch.rand(B, T, d.feat_dims, generator=g) * 2 - 1).to(dev)
    aux = (torch.randn(B, T, d.res_out_dims, generator=g) * 0.5).to(dev)
    kw = dict(variant=variant, head=d.head)
    with torch.no_grad():
        s = {k: v.contiguous() for k, v in wrn.hoist_aux(model, d, mels_up, aux).items()}
        w = wrn.step_weights(model, d)
        got, k_logits = _counted(COUNT_NAME[variant], lambda: wavernn_generate_core(
            w, s, 0, argmax=True, return_logits=True, **kw))
        ref, p_logits = wavernn_generate_core_plain(w, s, 0, argmax=True, return_logits=True,
                                                    **kw)
    torch.testing.assert_close(k_logits, p_logits, atol=1e-4, rtol=0)
    if d.head == "categorical":
        C = d.n_classes
        assert torch.equal(torch.round((got + 1) * (C - 1) / 2),
                           torch.round((ref + 1) * (C - 1) / 2))
    else:
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    return d


@pytest.mark.parametrize("variant,mode", CELLS)
def test_wavernn_kernel_full_width_matches_plain(dev, variant, mode):
    """Each cell at its default widths, 13 folds x 64 steps."""
    _full_width_greedy(dev, variant, mode, 13, 64)


# fatchord's phase buffer fills the shared memory from about 340 folds; the
# others stop at MAX_FOLD_BLOCK folds
@pytest.mark.parametrize("variant,mode,B", [
    ("fatchord-wavernn", "RAW", 400), ("fatchord-wavernn", "MOL", 400),
    ("geneing-wavernn", "BITS", 600), ("runtimeracer-wavernn", "RAW", 600),
    ("runtimeracer-wavernn", "MOL", 600)])
def test_wavernn_kernel_fold_blocks_match_plain(dev, variant, mode, B):
    """Past the fold block: the kernel loops over blocks of ``fb`` < B folds
    (its partials, reductions and GRU / FC items indexed by block), at
    default widths, 16 steps."""
    d = _full_width_greedy(dev, variant, mode, B, 16)
    p = k1_plan(variant, d.rnn_dims, d.fc_dims, d.n_classes, B, *_build.device_limits(dev),
                head=d.head)
    assert p.fb < B


def test_wavernn_kernel_rejects_bad_input(dev):
    w, s, d = _voc(dev, variant="fatchord-wavernn")
    with pytest.raises(ValueError, match="fc1_aux"):
        wavernn_generate_core(w, {**s, "fc1_aux": s["fc1_aux"][:, :, :8].contiguous()}, 0,
                              variant="fatchord-wavernn")
    with pytest.raises(ValueError, match="beta head"):
        wavernn_generate_core(w, s, 0, variant="fatchord-wavernn", head="beta")
    with pytest.raises(KeyError):
        wavernn_generate_core(w, s, 0, variant="runtimeracer-wavernn")


# one frame, a tile less one, a tile and one more, a 3.77 s utterance, the
# clone path's make_spectrogram size (its 400-frame mel), a minute of audio
# and more (the first group size of 8 rows a CTA and the last of 1 both run)
@pytest.mark.parametrize("T", [1, 31, 33, 302, 400, 4801, 10000])
@pytest.mark.parametrize("symmetric,clip", [(True, True), (False, True), (True, False),
                                            (False, False)])
def test_mel_project_kernel_matches_plain(dev, T, symmetric, clip):
    pp = preprocessing.replace(symmetric_mels=symmetric, allow_clipping_in_normalization=clip)
    g = torch.Generator().manual_seed(5)
    # magnitudes over ten decades, so that the floor and both clips are reached
    mag = (10.0 ** (torch.rand(sp.n_fft // 2 + 1, T, generator=g) * 10 - 7)).to(dev)
    got = _counted("mel_project", lambda: mel_project_normalize(mag, sp, pp))
    want = mel_project_normalize_plain(mag, sp, pp)
    assert got.shape == (80, T)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
    # no sum goes through an atomic: a second run gives the same bits
    assert torch.equal(got, mel_project_normalize(mag, sp, pp))


def test_mel_project_kernel_on_the_melspectrogram_path(dev):
    g = torch.Generator().manual_seed(5)
    n_samples = 960000  # a minute of audio: 4801 frames
    wav = (torch.randn(n_samples, generator=g) * torch.linspace(0, 2, n_samples)).to(dev)
    mag = taudio.stft_magnitude(wav, sp.n_fft, sp.hop_size, sp.win_size).contiguous()
    got = _counted("mel_project", lambda: mel_project_normalize(mag, sp, preprocessing))
    torch.testing.assert_close(got, mel_project_normalize_plain(mag, sp, preprocessing),
                               atol=2e-4, rtol=0)
    mel = _counted("mel_project", lambda: taudio.melspectrogram(wav, sp, preprocessing))
    assert mel.shape == got.shape == (80, 1 + n_samples // 200)


def test_mel_project_kernel_rejects_bad_input(dev):
    mag = torch.zeros(513, 40, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        mel_project_normalize(mag.t().contiguous().t(), sp, preprocessing)
    with pytest.raises(ValueError, match="basis"):
        mel_project_normalize(mag[:512].contiguous(), sp, preprocessing)
    with pytest.raises(ValueError, match="f32"):
        mel_project_normalize(mag.double(), sp, preprocessing)


def _taco_train_case(dev, B, T, n, D, L, E, KS=31, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=0.3):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    w = tk.TrainWeights(
        gwh=r(D, 3 * D, s=D ** -0.5), gbh=r(3 * D, s=0.1), wq=r(D, D, s=D ** -0.5),
        bq=r(D, s=0.1), mloc=r(KS, D), vv=r(D), wri=r(E + D, L, s=(E + D) ** -0.5),
        bri=r(L, s=0.1), l1wi=r(L, 4 * L, s=L ** -0.5), l1wh=r(L, 4 * L, s=L ** -0.5),
        l1b=r(4 * L, s=0.1), l2wi=r(L, 4 * L, s=L ** -0.5), l2wh=r(L, 4 * L, s=L ** -0.5),
        l2b=r(4 * L, s=0.1), gwi_ctx=r(E, 3 * D, s=E ** -0.5))
    lens = torch.randint(max(T - 8, 1), T + 1, (B,), generator=g)
    x = dict(xg_pre=r(n, B, 3 * D, s=1.0), enc_seq=r(B, T, E, s=0.5), enc_proj=r(B, T, D, s=0.5),
             char_mask=(torch.arange(T)[None, :] < lens[:, None]).float().to(dev),
             zo1=(torch.rand(n, B, L, generator=g) < 0.1).float().to(dev),
             zo2=(torch.rand(n, B, L, generator=g) < 0.1).float().to(dev))
    cots = [r(n, B, L, s=1.0), r(n, B, E, s=1.0), r(n, B, T, s=1.0)]
    return w, x, cots


# a mid size, an odd T with one row, and widths that take the kernels'
# scalar path (not multiples of 4) with a short conv
@pytest.mark.parametrize("B,T,n,D,L,E,KS", [(5, 40, 12, 128, 256, 384, 31),
                                            (1, 21, 5, 128, 128, 128, 31),
                                            (3, 9, 4, 13, 10, 7, 5)])
def test_taco_train_kernels_match_plain(dev, B, T, n, D, L, E, KS):
    w, x, cots = _taco_train_case(dev, B, T, n, D, L, E, KS)
    x_all, res = _counted("tacotron_train_fwd", lambda: tk.taco_train_fwd(w, **x))
    p_x, p_res = tk.taco_train_fwd_plain(w, **x)
    assert rel_err(x_all, p_x) <= 1e-5
    for name, a, b in zip(res._fields, res, p_res):
        assert rel_err(a, b) <= 1e-5, name
    args = (p_res, x["enc_seq"], x["enc_proj"], x["char_mask"], x["zo1"], x["zo2"], *cots)
    got = _counted("tacotron_train_bwd", lambda: tk.taco_train_bwd(w, *args))
    for name, a, b in zip(got._fields, got, tk.taco_train_bwd_plain(w, *args)):
        assert rel_err(a, b) <= 1e-4, name
    again = tk.taco_train_bwd(w, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs differ in their bits"
    _assert_train_fn_grads_match_plain(w, x, cots)


_GRAD_INPUTS = ("xg_pre", "enc_seq", "enc_proj")


def _assert_train_fn_grads_match_plain(w, x, cots):
    """Both K5 kernels through ``TacoDecoderTrainFn`` (the weight gradients
    are the wrapper's ``outer`` products and per-CTA sums), against autograd
    of the plain forward: every weight's and input's gradient within 1e-4
    of the reference's largest entry."""

    def grads(fwd):
        lw = tk.TrainWeights(*(t.clone().requires_grad_() for t in w))
        lx = {k: (v.clone().requires_grad_() if k in _GRAD_INPUTS else v) for k, v in x.items()}
        torch.autograd.backward(fwd(lw, lx), cots)
        return [t.grad for t in lw] + [lx[k].grad for k in _GRAD_INPUTS]

    def plain(lw, lx):
        p_x, p_res = tk.taco_train_fwd_plain(lw, **lx)
        return p_x, p_res.ctx, p_res.scores

    before = _build.launch_counts["tacotron_train_bwd"]
    got = grads(lambda lw, lx: tk.taco_decoder_train(lw, **lx))
    assert _build.launch_counts["tacotron_train_bwd"] == before + 1
    for name, a, b in zip(w._fields + _GRAD_INPUTS, got, grads(plain)):
        assert rel_err(a, b) <= 1e-4, name


# the default widths at a short walk, and the first session of the
# schedule (batch 112, 86 iterations, 160 characters)
@pytest.mark.parametrize("B,T,n", [(3, 20, 4), (112, 160, 86)])
def test_taco_train_fn_grads_match_autograd_of_plain(dev, B, T, n):
    w, x, cots = _taco_train_case(dev, B, T, n, 256, 512, 896)
    _assert_train_fn_grads_match_plain(w, x, cots)


def test_taco_train_kernels_reject_bad_input(dev):
    w, x, _ = _taco_train_case(dev, 2, 9, 3, 16, 8, 8)
    with pytest.raises(ValueError, match="enc_proj"):
        tk.taco_train_fwd(w, **{**x, "enc_proj": x["enc_proj"][:, :, :8]})
    with pytest.raises(ValueError, match="odd"):
        tk.taco_train_fwd(w._replace(mloc=w.mloc[:30]), **x)
    long_conv, xl, _ = _taco_train_case(dev, 2, 9, 3, 16, 8, 8, KS=33)
    with pytest.raises(ValueError, match="at most 31"):
        tk.taco_train_fwd(long_conv, **xl)


def _bwd_args(dev, B, T, n, D, L, E, KS=31, transposed=False):
    w, x, cots = _taco_train_case(dev, B, T, n, D, L, E, KS)
    if transposed:
        # the matrices as prepare_train_weights gives them: transposed views
        # of (out, in) parameters
        w = w._replace(**{k: getattr(w, k).t().contiguous().t() for k in (
            "gwh", "wq", "wri", "l1wi", "l1wh", "l2wi", "l2wh", "gwi_ctx")})
    _, p_res = tk.taco_train_fwd_plain(w, **x)
    return w, (p_res, x["enc_seq"], x["enc_proj"], x["char_mask"], x["zo1"], x["zo2"], *cots)


# narrow, ragged (the scalar path, a short conv) and the default widths
@pytest.mark.parametrize("B,T,n,D,L,E,KS", [(5, 40, 12, 128, 256, 384, 31),
                                            (3, 9, 4, 13, 10, 7, 5),
                                            (3, 20, 4, 256, 512, 896, 31)])
@pytest.mark.parametrize("candidate", tk.CANDIDATES)
def test_taco_train_bwd_candidates_match_plain(dev, B, T, n, D, L, E, KS, candidate):
    """K5's backward under each candidate partition of the plan, forced,
    against the plain version (1e-4 of each output's largest entry) and
    twice with equal bits."""
    w, args = _bwd_args(dev, B, T, n, D, L, E, KS)
    p = tk.device_plan_bwd(n, B, T, (D, L, E, KS), dev, candidate=candidate)
    lib = _build.library()
    got = tk.bwd_launch(lib, w, *args, p=p)
    again = tk.bwd_launch(lib, w, *args, p=p)
    want = tk.taco_train_bwd_plain(w, *args)
    for name, a, b in zip(got._fields, got, want):
        assert rel_err(a, b) <= 1e-4, name
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs differ in their bits"


def test_taco_train_bwd_past_resident_matches_plain(dev):
    """At batch 112 the weight slices stop fitting in shared memory beside
    the staged rows past T_text 408: a longer text runs a candidate that
    reads them from L2. Its result against the plain version (1e-4), twice
    with equal bits."""
    B, T, n, dims = 112, 420, 3, (256, 512, 896, 31)
    w, args = _bwd_args(dev, B, T, n, *dims)
    p = tk.device_plan_bwd(n, B, T, dims, dev)
    assert p.name != "resident x1"
    got = _counted("tacotron_train_bwd", lambda: tk.taco_train_bwd(w, *args))
    again = tk.taco_train_bwd(w, *args)
    for name, a, b in zip(got._fields, got, tk.taco_train_bwd_plain(w, *args)):
        assert rel_err(a, b) <= 1e-4, name
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs differ in their bits"


def test_taco_train_bwd_reads_transposed_views(dev):
    """The backward gathers its weight slices from the matrices as
    TrainWeights holds them: transposed views of the parameters give the
    same result as contiguous copies, with no copy made by the wrapper."""
    w, args = _bwd_args(dev, 4, 24, 5, 64, 96, 80, transposed=True)
    assert not w.l1wi.is_contiguous()
    got = _counted("tacotron_train_bwd", lambda: tk.taco_train_bwd(w, *args))
    want = tk.taco_train_bwd_plain(w, *args)
    for name, a, b in zip(got._fields, got, want):
        assert rel_err(a, b) <= 1e-4, name


def test_taco_train_bwd_refuses_what_does_not_fit(dev):
    w, args = _bwd_args(dev, 2, 9, 3, 16, 8, 8, KS=33)
    with pytest.raises(ValueError, match="at most 31"):
        tk.taco_train_bwd(w, *args)
    w, args = _bwd_args(dev, 2, 9, 3, 16, 8, 8)
    with pytest.raises(ValueError, match="past the limit of 4096"):
        tk.bwd_launch(_build.library(), w, *args,
                      p=tk.plan_bwd(3, 2, 9, (16, 8, 8, 31), 132, 4096))
    bad = tk.plan_bwd(3, 2, 9, (16, 8, 8, 31), *_build.device_limits(dev))
    with pytest.raises(RuntimeError, match="rtvc_tacotron_train_bwd"):
        tk.bwd_launch(_build.library(), w, *args, p=bad._replace(smem=4))
    with pytest.raises(ValueError, match="l1wi"):
        tk.taco_train_bwd(w._replace(l1wi=w.l1wi[:, :8]), *args)


def _assert_fwd_matches_plain(got, want, tol):
    (x_all, res), (p_x, p_res) = got, want
    assert rel_err(x_all, p_x) <= tol, "x_all"
    for name, a, b in zip(res._fields, res, p_res):
        assert rel_err(a, b) <= tol, name


def _assert_same_bits(got, again):
    (x_all, res), (x_again, res_again) = got, again
    assert torch.equal(x_all, x_again), "two runs differ in their bits"
    assert all(torch.equal(a, b) for a, b in zip(res, res_again)), "two runs differ in their bits"


# narrow, ragged (the scalar paths, a short conv) and the default widths
@pytest.mark.parametrize("B,T,n,D,L,E,KS", [(5, 40, 12, 128, 256, 384, 31),
                                            (3, 9, 4, 13, 10, 7, 5),
                                            (3, 20, 4, 256, 512, 896, 31)])
@pytest.mark.parametrize("candidate", tk.CANDIDATES)
def test_taco_train_fwd_candidates_match_plain(dev, B, T, n, D, L, E, KS, candidate):
    """K5's forward under each candidate partition of the plan, forced,
    against the plain version (1e-5 of each output's largest entry, as the
    wrapper's test) and twice with equal bits."""
    w, x, _ = _taco_train_case(dev, B, T, n, D, L, E, KS)
    p = tk.device_plan_fwd(n, B, T, (D, L, E, KS), dev, candidate=candidate)
    lib = _build.library()
    got = tk.fwd_launch(lib, w, **x, p=p)
    again = tk.fwd_launch(lib, w, **x, p=p)
    _assert_fwd_matches_plain(got, tk.taco_train_fwd_plain(w, **x), 1e-5)
    _assert_same_bits(got, again)


def test_taco_train_fwd_full_width_matches_plain(dev):
    """The forward at the first session of the schedule (batch 112, 86
    steps, 160 characters, the default widths), through the wrapper and the
    card's plan: against the plain version (1e-4 of each output's largest
    entry: f32 sums in another order, carried through 86 steps), twice with
    equal bits."""
    w, x, _ = _taco_train_case(dev, 112, 160, 86, 256, 512, 896)
    got = _counted("tacotron_train_fwd", lambda: tk.taco_train_fwd(w, **x))
    again = tk.taco_train_fwd(w, **x)
    _assert_fwd_matches_plain(got, tk.taco_train_fwd_plain(w, **x), 1e-4)
    _assert_same_bits(got, again)


def _taco_train_init_case(dev, B, T, n, D=256, L=512, E=896, KS=31, seed=7):
    """The chain's weights at PyTorch's initial scale (uniform within
    ±1/√fan in; the location taps ⊗ L normal, 0.1), as ``chip_smoke.py``
    draws them, the inputs of ``_taco_train_case`` and zoneout 0 (the
    alignment pass's)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * fan ** -0.5).to(dev)

    w = tk.TrainWeights(
        gwh=u(D, 3 * D, fan=D), gbh=u(3 * D, fan=D), wq=u(D, D, fan=D), bq=u(D, fan=D),
        mloc=(torch.randn(KS, D, generator=g) * 0.1).to(dev), vv=u(D, fan=D),
        wri=u(E + D, L, fan=E + D), bri=u(L, fan=E + D), l1wi=u(L, 4 * L, fan=L),
        l1wh=u(L, 4 * L, fan=L), l1b=u(4 * L, fan=L), l2wi=u(L, 4 * L, fan=L),
        l2wh=u(L, 4 * L, fan=L), l2b=u(4 * L, fan=L), gwi_ctx=u(E, 3 * D, fan=E))
    _, x, _ = _taco_train_case(dev, B, T, n, D, L, E, KS, seed)
    x["zo1"].zero_()
    x["zo2"].zero_()
    return w, x


# the alignment pass: one utterance (B 1, r 1) over the longest padded mel
# (1216 iterations) and the text bucket's 160 characters, and a short one
@pytest.mark.parametrize("T,n", [(160, 1216), (48, 320)])
def test_taco_train_fwd_aligner_shape_matches_plain(dev, T, n):
    w, x = _taco_train_init_case(dev, 1, T, n)
    got = _counted("tacotron_train_fwd", lambda: tk.taco_train_fwd(w, **x))
    again = tk.taco_train_fwd(w, **x)
    _assert_fwd_matches_plain(got, tk.taco_train_fwd_plain(w, **x), 1e-4)
    _assert_same_bits(got, again)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_taco_train_fwd_long_walk_tracks_f64(dev, seed):
    """At ``_taco_train_case``'s weights (normal, std 1/√fan: about 1.7x the
    initial scale) one row's walk over 1216 steps is chaotic: rounding grows
    by orders of magnitude after a few hundred steps, so two f32 orders of
    summation part at the end, by an amount the seed decides (PERF.md gives
    the readings). The kernel is held to an f64 run of the plain version
    where rounding has not grown, within 1e-5 of its largest entry over the
    first 300 steps (as the f32 plain version is), and at every one of the
    1216 steps to one f64 step of the plain version taken from the kernel's
    own state a step back: each stream within 1e-5 of its largest entry.
    Prints the distances from the f64 run (run with ``-s`` to read them)."""
    w, x, _ = _taco_train_case(dev, 1, 160, 1216, 256, 512, 896, seed=seed)
    x["zo1"].zero_()
    x["zo2"].zero_()
    got, res = tk.taco_train_fwd(w, **x)
    plain, _ = tk.taco_train_fwd_plain(w, **x)
    w64 = tk.TrainWeights(*(t.double() for t in w))
    x64 = {k: v.double() for k, v in x.items()}
    ref, _ = tk.taco_train_fwd_plain(w64, **x64)
    scale = ref.abs().max()

    def drift(a):
        return (a.double() - ref).abs().amax(dim=(1, 2)) / scale

    d_kernel, d_plain = drift(got), drift(plain)
    print(f"K5 long walk, seed {seed}: distance from f64 over the first 300 steps kernel "
          f"{float(d_kernel[:300].max()):.3e} plain {float(d_plain[:300].max()):.3e}; at step "
          f"1216 kernel {float(d_kernel[-1]):.3e} plain {float(d_plain[-1]):.3e} (ratio "
          f"{float(d_kernel[-1] / d_plain[-1]):.2f})")
    assert float(d_kernel[:300].max()) <= 1e-5 and float(d_plain[:300].max()) <= 1e-5

    # the kernel's state a step back (zero at step 0; the cumulative scores
    # summed in f32 step by step, as the kernel sums them), the 1216 steps
    # taken in f64 as one batch
    def prev(t):
        return torch.cat([torch.zeros_like(t[:1]), t[:-1]])[:, 0].double()

    cum, cums = torch.zeros_like(res.cum_T), []
    for scores in res.scores:
        cums.append(cum)
        cum = cum + scores
    assert rel_err(cum, res.cum_T) <= 1e-6
    n = got.shape[0]
    state = tk.FwdState(prev(res.ah), prev(res.ctx), torch.cat(cums).double(), prev(res.h1),
                        prev(res.c1), prev(res.h2), prev(res.c2))
    x_step, streams, _ = tk.fwd_step_plain(
        w64, x64["xg_pre"][:, 0], x64["enc_seq"].expand(n, -1, -1),
        x64["enc_proj"].expand(n, -1, -1), x64["char_mask"].expand(n, -1), x64["zo1"][:, 0],
        x64["zo2"][:, 0], state)
    errs = {k: rel_err(getattr(res, k)[:, 0].double(), v) for k, v in streams.items()}
    errs["x_all"] = rel_err(got[:, 0].double(), x_step)
    print(f"K5 long walk, seed {seed}: each step against an f64 step from the kernel's state, "
          f"worst {max(errs.values()):.3e} ({max(errs, key=errs.get)})")
    assert max(errs.values()) <= 1e-5, errs


def test_taco_train_fwd_past_resident_matches_plain(dev):
    """At batch 112 the forward's weight slices stop fitting in shared
    memory beside its staged rows past T_text 999: a longer text runs a
    candidate that reads them from L2. Its result against the plain version
    (1e-5), twice with equal bits."""
    B, T, n, dims = 112, 1000, 3, (256, 512, 896, 31)
    w, x, _ = _taco_train_case(dev, B, T, n, *dims)
    assert tk.device_plan_fwd(n, B, T, dims, dev).name != "resident x1"
    got = _counted("tacotron_train_fwd", lambda: tk.taco_train_fwd(w, **x))
    again = tk.taco_train_fwd(w, **x)
    _assert_fwd_matches_plain(got, tk.taco_train_fwd_plain(w, **x), 1e-5)
    _assert_same_bits(got, again)


def test_taco_train_fwd_reads_transposed_views(dev):
    """The forward gathers its weight slices from the matrices as
    prepare_train_weights gives them: transposed views of the parameters,
    and gwi_ctx a column slice of the attention GRU's weight_ih. The kernel
    receives those tensors' own storage and strides (no copy made), and the
    result matches the plain version's (1e-5)."""
    w, x, _ = _taco_train_case(dev, 4, 24, 5, 64, 96, 80)
    E, P = 80, 24
    weight_ih = torch.cat([w.gwi_ctx.t(), torch.randn(3 * 64, P, device=dev)], dim=1)
    w = w._replace(gwi_ctx=weight_ih[:, :E].t(), **{k: getattr(w, k).t().contiguous().t() for k in (
        "gwh", "wq", "wri", "l1wi", "l1wh", "l2wi", "l2wh")})
    assert not w.gwi_ctx.is_contiguous() and not w.l1wi.is_contiguous()
    lib = _build.library()
    seen = {}

    class Recording:
        def rtvc_tacotron_train_fwd(self, weights, strides, *rest):
            seen["weights"] = [weights[i] for i in range(8)]
            seen["strides"] = [strides[i] for i in range(16)]
            return lib.rtvc_tacotron_train_fwd(weights, strides, *rest)

    got = tk.fwd_launch(Recording(), w, **x)
    mats = [getattr(w, k) for k in ("gwh", "wq", "wri", "l1wi", "l1wh", "l2wi", "l2wh",
                                    "gwi_ctx")]
    assert seen["weights"] == [m.data_ptr() for m in mats]
    assert seen["strides"] == [s for m in mats for s in m.stride()]
    _assert_fwd_matches_plain(got, tk.taco_train_fwd_plain(w, **x), 1e-5)


def test_taco_train_fwd_refuses_what_does_not_fit(dev):
    w, x, _ = _taco_train_case(dev, 2, 9, 3, 16, 8, 8, KS=33)
    with pytest.raises(ValueError, match="at most 31"):
        tk.taco_train_fwd(w, **x)
    w, x, _ = _taco_train_case(dev, 2, 9, 3, 16, 8, 8)
    with pytest.raises(ValueError, match="past the limit of 4096"):
        tk.fwd_launch(_build.library(), w, **x, p=tk.plan_fwd(3, 2, 9, (16, 8, 8, 31), 132, 4096))
    bad = tk.plan_fwd(3, 2, 9, (16, 8, 8, 31), *_build.device_limits(dev))
    with pytest.raises(RuntimeError, match="rtvc_tacotron_train_fwd"):
        tk.fwd_launch(_build.library(), w, **x, p=bad._replace(smem=4))
    with pytest.raises(ValueError, match="l1wi"):
        tk.taco_train_fwd(w._replace(l1wi=w.l1wi[:, :8]), **x)


# the GTA pass at B 8, r 2 (``chip_smoke.py``'s phase_gta): a batch of the
# shorter utterances and one of the longest (1200 frames: 602 iterations
# over the 160-character bucket)
@pytest.mark.parametrize("T,n", [(96, 334), (160, 602)])
def test_taco_train_fwd_gta_shapes_match_plain(dev, T, n):
    w, x = _taco_train_init_case(dev, 8, T, n)
    got = _counted("tacotron_train_fwd", lambda: tk.taco_train_fwd(w, **x))
    again = tk.taco_train_fwd(w, **x)
    _assert_fwd_matches_plain(got, tk.taco_train_fwd_plain(w, **x), 1e-4)
    _assert_same_bits(got, again)


GTA_NARROW = {
    "tacotron": dict(embed_dims=16, encoder_dims=16, decoder_dims=32, postnet_dims=16,
                     encoder_K=4, lstm_dims=32, postnet_K=4, num_highways=2),
    "forward-tacotron": dict(embed_dims=16, series_embed_dims=8, duration_conv_dims=12,
                             duration_rnn_dims=8, pitch_conv_dims=12, pitch_rnn_dims=8,
                             energy_conv_dims=12, energy_rnn_dims=8, prenet_dims=16,
                             prenet_k=3, prenet_num_highways=2, rnn_dims=16, postnet_dims=12,
                             postnet_k=3, postnet_num_highways=2),
}


def _write_gta_root(root, n_utts=5, seed=0):
    """A tiny synthesizer root with the alignment pass's files: 80-band
    mels of 20-40 frames, unit 768-d embeddings, durations summing to each
    mel over its text's characters, pitch and energy."""
    from rtvc_tpu_torch.config import preprocessing
    from rtvc_tpu_torch.text import text_to_sequence

    rng = np.random.default_rng(seed)
    for d in ("mels", "embeds", "duration", "attention", "alignment", "phoneme_pitch",
              "phoneme_energy"):
        (root / d).mkdir(parents=True, exist_ok=True)
    meta = {}
    for i in range(n_utts):
        uid, n = f"utt{i:03d}", int(rng.integers(20, 41))
        text = ["hello there", "a short one", "voice clone"][i % 3] + f" {i}"
        chars = len(text_to_sequence(text, preprocessing.cleaner_names))
        cuts = np.sort(rng.integers(0, n + 1, chars - 1))
        files = {"mels/mel": rng.uniform(-4, 0, (n, 80)).astype(np.float32),
                 "duration/duration": np.diff(np.concatenate([[0], cuts, [n]])),
                 "attention/attention": np.float32(0.9), "alignment/alignment": np.float32(0.8),
                 "phoneme_pitch/phoneme-pitch": rng.uniform(0, 2, chars).astype(np.float32),
                 "phoneme_energy/phoneme-energy": rng.uniform(0, 2, chars).astype(np.float32)}
        for stem, a in files.items():
            np.save(root / f"{stem}-{uid}.npy", a)
        e = rng.standard_normal(768).astype(np.float32)
        np.save(root / "embeds" / f"embed-{uid}.npy", e / np.linalg.norm(e))
        meta.setdefault(f"spk{i % 2}", []).append(f"{uid}|{n * 200}|{n}|{text}")
    (root / "train.json").write_text(__import__("json").dumps(meta))
    return root


@pytest.mark.parametrize("model_type", ["tacotron", "forward-tacotron"])
def test_gta_pass_on_the_card_matches_its_cpu_route(dev, tmp_path, model_type):
    """The GTA pass (``train.gta.run_synthesis``, batch 2, r 2) with the same
    narrow weights on the card and on the CPU: every saved mel within 1e-4,
    ``synthesized.json`` equal; on the card Tacotron's decoder chain is one
    K5 forward launch a batch (no backward), ForwardTacotron's BiLSTM two K3
    launches a batch and its five BiGRUs ten K4 launches."""
    from rtvc_tpu_torch.train.gta import run_synthesis

    root = _write_gta_root(tmp_path / "syn")
    cfg = factories.default_config(model_type).replace(**GTA_NARROW[model_type])
    names = ("tacotron_train_fwd", "tacotron_train_bwd", "lstm_seq", "gru_seq")
    mels = {}
    for where in ("cpu", dev):
        bundle = factories.init_syn_model(model_type, seed=4, override_hp=cfg, device=where)
        before = dict(_build.launch_counts)
        assert run_synthesis(root, tmp_path / str(where), bundle, r=2, batch_size=2) == 5
        torch.cuda.synchronize()
        launched = {k: _build.launch_counts[k] - before.get(k, 0) for k in names}
        mels[str(where)] = {p.stem: np.load(p)
                            for p in (tmp_path / str(where) / "mels_gta").iterdir()}
    batches = 3
    assert launched == ({"tacotron_train_fwd": batches, "tacotron_train_bwd": 0, "lstm_seq": 0,
                         "gru_seq": 4 * batches} if model_type == "tacotron" else
                        {"tacotron_train_fwd": 0, "tacotron_train_bwd": 0,
                         "lstm_seq": 2 * batches, "gru_seq": 10 * batches})
    assert mels[str(dev)].keys() == mels["cpu"].keys() and len(mels["cpu"]) == 5
    for uid, mel in mels["cpu"].items():
        np.testing.assert_allclose(mels[str(dev)][uid], mel, atol=1e-4, rtol=0, err_msg=uid)
    assert (tmp_path / str(dev) / "synthesized.json").read_text() == \
        (tmp_path / "cpu" / "synthesized.json").read_text()


def test_gen_testset_on_the_card_writes_finite_wavs(dev, tmp_path):
    """``train.gen_testset`` with a narrow runtimeracer on the card: the
    three wavs an item (the generated one through K1, one launch an item),
    finite, of the item's length, and the model's state untouched."""
    import json

    from scipy.io import wavfile

    from rtvc_tpu_torch.config.vocoder import WaveRNNParams
    from rtvc_tpu_torch.data.vocoder_dataset import VocoderDataset
    from rtvc_tpu_torch.train.gen_testset import gen_testset

    rng = np.random.default_rng(2)
    for d in ("mels_gta", "wav"):
        (tmp_path / d).mkdir()
    meta = {}
    for i in range(2):
        uid = f"utt{i:03d}"
        np.save(tmp_path / "mels_gta" / f"{uid}.npy", rng.uniform(-4, 4, (30, 80)).astype(
            np.float32))
        np.save(tmp_path / "wav" / f"audio-{uid}.npy",
                (0.5 * np.sin(np.linspace(0, 300, 6000) + i)).astype(np.float32))
        meta[uid] = f"{uid}|6000|30|text"
    (tmp_path / "synthesized.json").write_text(json.dumps(meta))
    cfg = WaveRNNParams(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=32,
                        res_blocks=1, gen_target=1000, gen_overlap=200)
    d = factories.wavernn_dims("runtimeracer-wavernn", cfg)
    model = factories.init_wavernn(d, seed=1, device=dev).train()
    state = {k: t.clone() for k, t in model.state_dict().items()}
    ds = VocoderDataset(tmp_path / "synthesized.json", tmp_path / "mels_gta", tmp_path / "wav",
                        cfg)
    name = COUNT_NAME[d.variant]
    before = _build.launch_counts[name]
    gen_testset(model, d, cfg, ds, tmp_path / "samples", 4)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 2
    assert model.training and all(torch.equal(t, state[k]) for k, t in model.state_dict().items())
    for i in range(2):
        for kind in ("target", "griffinlim", "generated"):
            sr, wav = wavfile.read(tmp_path / "samples" / f"4_{i}_{kind}.wav")
            assert sr == 16000 and np.isfinite(wav).all() and np.abs(wav).max() > 0, kind
            assert abs(len(wav) - 30 * 200) <= 200, (kind, len(wav))


# ---------------------------------------------------------------------------
# K1's (compute_dtype, stream_dtype) pairs: the vocoder's generation options
# ---------------------------------------------------------------------------

K1_PAIRS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
            (torch.bfloat16, torch.float32)]


def _as_pair(w, s, compute, stream):
    return ({k: v.to(compute) for k, v in w.items()},
            {k: v.to(stream).contiguous() for k, v in s.items()})


def _held_greedy(got, kl, ref, pl, head, C, tol):
    """Greedy kernel samples and head inputs against the plain version's:
    per fold, up to the first step where the decoded choice parts (labels,
    or continuous samples beyond ``tol``), head inputs within ``tol`` and
    samples within 1e-6 (categorical) or ``tol``; where they part, the plain
    version's two top choices within twice the two versions' head-input
    difference there (``chip_smoke.py:k1_check``'s near-tie rule; the beta
    head has no choice to tie). Returns the folds that parted."""
    T, parted = got.shape[1], 0
    for b in range(got.shape[0]):
        if head == "categorical":
            lab = lambda x: torch.round((x + 1) * (C - 1) / 2)  # noqa: E731
            differ, choice, stol = lab(got[b]) != lab(ref[b]), pl[b], 1e-6
        else:
            differ, choice, stol = (got[b] - ref[b]).abs() > tol, pl[b, :, :C // 3], tol
        idx = torch.nonzero(differ)
        t = int(idx[0]) if len(idx) else T
        if t:
            assert float((kl[b, :t] - pl[b, :t]).abs().max()) <= tol
            assert float((got[b, :t] - ref[b, :t]).abs().max()) <= stol
        if t < T:
            assert head != "beta", f"fold {b}: beta samples part at step {t}"
            noise = float((kl[b, t] - pl[b, t]).abs().max())
            top2 = torch.topk(choice[t], 2).values
            assert float(top2[0] - top2[1]) <= 2 * noise, f"fold {b} parts at step {t}"
            parted += 1
    return parted


@pytest.mark.parametrize("compute,stream", K1_PAIRS)
@pytest.mark.parametrize("variant,mode", CELLS)
def test_wavernn_kernel_pairs_greedy_match_plain(dev, variant, mode, compute, stream):
    """Every cell at a small width, 13 folds x 300 steps, at each new pair.
    bf16 streams over f32 weights: as the f32 kernel (head inputs within
    1e-5, labels equal, MOL and beta samples within 1e-5). bf16 weights: the
    carried states and the fed-back sample are rounded to bf16, and two f32
    sums a few units apart round apart where they lie that close to a bf16
    midpoint (one bf16 unit of a state): head inputs within 1e-3, up to a
    near-tie."""
    w, s, d = _voc(dev, B=13, T=300, variant=variant, mode=mode)
    last = LAYERS[variant].fcs[-1].name
    w[f"{last}_w"] = (torch.randn(w[f"{last}_w"].shape,
                                  generator=torch.Generator().manual_seed(6)) * 2.0).to(dev)
    w, s = _as_pair(w, s, compute, stream)
    kw = dict(variant=variant, head=d.head)
    got, kl = _counted(count_name(variant, compute, stream), lambda: wavernn_generate_core(
        w, s, 0, argmax=True, return_logits=True, **kw))
    ref, pl = wavernn_generate_core_plain(w, s, 0, argmax=True, return_logits=True, **kw)
    assert got.dtype == kl.dtype == torch.float32
    assert float(pl.std(dim=1).max()) > 1e-3
    if compute == torch.float32:
        torch.testing.assert_close(kl, pl, atol=1e-5, rtol=0)
        torch.testing.assert_close(got, ref, atol=1e-5 if d.head != "categorical" else 1e-6,
                                   rtol=0)
    else:
        _held_greedy(got, kl, ref, pl, d.head, d.n_classes, 1e-3)


def _rounding_probe(dev, B=13, T=12, R=16, F=16, C=64, seed=0):
    """runtimeracer's layers with structured weights, so that each place
    where a bf16-weight instantiation rounds moves the head's inputs by
    5e-3 to 2e-2 from the first steps (measured on the plain version with
    each rounding taken out, or the residual taken after it), while no
    product's order of summation matters: no GRU reads its input or state
    through a product (W_ih = W_hh = 0: each unit's state follows its
    biases, and the first GRU's stream), the FCs pass their inputs' mean on,
    and the last FC makes class c's input 0.08·c·f − c²/200, so the label
    follows f and the fed-back sample moves the input through i_col."""
    g = torch.Generator().manual_seed(seed)
    w = {k: torch.zeros(shape) for k, shape in
         wg.weight_shapes(wg.VOC_RUNTIMERACER, R, F, C).items()}
    w["i_col"] = torch.full((R,), 0.5)
    for k, name in enumerate(("rnn1", "rnn2", "rnn3", "rnn4")):
        b = torch.tensor([0.3 + 0.1 * k, -0.4 + 0.2 * k, 0.9 - 0.15 * k]).repeat_interleave(R)
        w[f"{name}_bhh"] = b
        if f"{name}_bih" in w:
            w[f"{name}_bih"] = 0.5 * b
    w["fc1_wx"] = torch.full((F, R), 1.0 / R)
    for name in ("fc2_w", "fc3_wx", "fc4_w"):
        w[name] = torch.full((F, F), 1.0 / F)
    c = torch.arange(C, dtype=torch.float32)
    w["fc5_w"] = 0.08 * c[:, None].repeat(1, F) / F
    w["fc5_b"] = -c * c / 200.0

    def per_fold(width, lo, hi):
        return (torch.rand(B, T, 1, generator=g) * (hi - lo) + lo).repeat(1, 1, width)

    s = {"i_cond": per_fold(R, -0.1, 0.1), "rnn3_aux": per_fold(3 * R, -0.1, 0.1),
         "fc1_aux": per_fold(F, 0.0, 0.5), "fc3_aux": per_fold(F, 0.0, 0.5)}
    return ({k: v.to(dev) for k, v in w.items()},
            {k: v.to(dev).contiguous() for k, v in s.items()})


@pytest.mark.parametrize("compute,stream", K1_PAIRS)
def test_wavernn_kernel_pairs_round_where_the_plain_version_does(dev, compute, stream):
    """On the rounding probe the kernel at each pair gives the plain
    version's head inputs within 1e-4 at every step and its labels, where a
    kernel that skipped a rounding of the carried states or of the fed-back
    sample, or took the residual after the rounding, would be 5e-3 to 2e-2
    off; and the probe tells a bf16-weight pair from f32 weights."""
    w32, s32 = _rounding_probe(dev)
    w, s = _as_pair(w32, s32, compute, stream)
    got, kl = _counted(count_name(VOC["variant"], compute, stream), lambda: wavernn_generate_core(
        w, s, 0, argmax=True, return_logits=True))
    ref, pl = wavernn_generate_core_plain(w, s, 0, argmax=True, return_logits=True)
    torch.testing.assert_close(kl, pl, atol=1e-4, rtol=0)
    assert torch.equal(torch.round((got + 1) * 63 / 2), torch.round((ref + 1) * 63 / 2))
    _, p32 = wavernn_generate_core_plain(*_as_pair(w32, s32, torch.float32, stream), 0,
                                         argmax=True, return_logits=True)
    assert (float((p32 - pl).abs().max()) > 1e-3) == (compute == torch.bfloat16)


def test_wavernn_kernel_bf16_weights_plan_matches_its_layout(dev, monkeypatch):
    """The wrapper's plan counts bf16 weights at two bytes (``elem`` 2), as
    the kernel's layout does: the launch with that plan runs; the same
    launch with the plan at four bytes is refused (the layout's size
    disagrees); and the two-byte plan needs less shared memory."""
    w, s, d = _voc(dev, B=13, T=40)
    w, s = _as_pair(w, s, torch.bfloat16, torch.bfloat16)
    limits = _build.device_limits(dev)
    p2, p4 = (k1_plan(d.variant, d.rnn_dims, d.fc_dims, d.n_classes, 13, *limits, head=d.head,
                      elem=e) for e in (2, 4))
    assert p2.smem < p4.smem and p2[:5] == p4[:5]
    wavernn_generate_core(w, s, 0, argmax=True)
    torch.cuda.synchronize()
    real = wg.plan
    monkeypatch.setattr(wg, "plan", lambda *a, **k: real(*a, **{**k, "elem": 4}))
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        wavernn_generate_core(w, s, 0, argmax=True)


def test_wavernn_kernel_refuses_mixed_dtypes(dev):
    w, s, _ = _voc(dev)
    with pytest.raises(ValueError, match="share one dtype"):
        wavernn_generate_core(w, {**s, "i_cond": s["i_cond"].to(torch.bfloat16)}, 0)
    with pytest.raises(ValueError, match="share one dtype"):
        wavernn_generate_core({**w, "i_col": w["i_col"].to(torch.bfloat16)}, s, 0)


def test_generation_options_switch_the_instantiation(dev, monkeypatch):
    """``set_generation_options`` picks the instantiation the vocoder's next
    launch takes, counted by pair, and ``stream_dtype=None`` with no
    ``compute_dtype`` returns the next launch to the f32 kernel."""
    from rtvc_tpu_torch.inference import vocoder as tvoc

    cfg = factories.default_config(VOC["variant"]).replace(
        rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=16, res_blocks=1)
    monkeypatch.setattr(tvoc, "_bundle", None)
    for name in ("_compute_dtype", "_stream_dtype", "_default_target", "_default_overlap"):
        monkeypatch.setattr(tvoc, name, getattr(tvoc, name))
    tvoc.load_bundle(factories.init_voc_model(VOC["variant"], seed=1, override_hp=cfg,
                                              device=dev))
    mel = np.random.default_rng(0).uniform(-4, 0, (80, 12)).astype(np.float32)
    f32 = COUNT_NAME[VOC["variant"]]
    for options, name in (({"stream_dtype": "bf16"}, "wavernn_generate_bf16_streams"),
                          ({"compute_dtype": "bf16", "stream_dtype": "bf16"},
                           "wavernn_generate_bf16"),
                          ({"compute_dtype": "bf16", "stream_dtype": None},
                           "wavernn_generate_bf16_weights"),
                          ({"stream_dtype": None}, f32)):
        tvoc.set_generation_options(target=600, overlap=100, **options)
        before = {n: _launches(n) for n in (f32, *wg.PAIR_COUNT_NAME.values())}
        wav = tvoc.infer_waveform(mel)
        torch.cuda.synchronize()
        after = {n: _launches(n) for n in before}
        assert {n: after[n] - before[n] for n in before if after[n] != before[n]} == {name: 1}
        assert wav.shape == (11 * 200,) and np.isfinite(wav).all()


# ---------------------------------------------------------------------------
# The preprocessing passes on the card: K6 in the audio pass, K3 in the
# embedding pass, both called from the passes' thread pools
# ---------------------------------------------------------------------------


def _write_preprocess_corpus(root, seed=0):
    """``<root>/Tiny/speakers/spk{0,1,2}``: three utterances of 1.5-4 s each
    (voiced segments between pauses), spk2 at 22 050 Hz. Returns ``root``."""
    from rtvc_tpu_torch.utils.io import save_wav_float

    rng = np.random.default_rng(seed)
    for s, sr in enumerate((16000, 16000, 22050)):
        d = root / "Tiny" / "speakers" / f"spk{s}"
        d.mkdir(parents=True)
        for u in range(3):
            parts = [np.zeros(int(0.3 * sr))]
            for k in range(2 + u):
                t = np.arange(int(rng.uniform(0.5, 1.2) * sr)) / sr
                f0 = 110 + 40 * s + 15 * k
                parts += [0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3 * f0 * t),
                          np.zeros(int(rng.uniform(0.3, 0.6) * sr))]
            wav = np.concatenate(parts) + 0.002 * rng.standard_normal(sum(map(len, parts)))
            save_wav_float(wav.astype(np.float32), d / f"utt{u}.wav", sr)
            (d / f"utt{u}.txt").write_text(f"utterance {u} of speaker {s}")
    return root


def _audio_pass(root, out, device, n_processes):
    from rtvc_tpu_torch.data.synthesizer_preprocess import synthesizer_preprocess_dataset

    return synthesizer_preprocess_dataset(root, out, "Tiny", ["speakers"], [".wav"], ".txt",
                                          n_processes=n_processes, device=device)


def _assert_audio_passes_agree(a, b, mel_tol):
    """Equal ``train.json`` and ``wav/`` files; mels within ``mel_tol``
    absolute (0: equal bits)."""
    assert (a / "train.json").read_text() == (b / "train.json").read_text()
    names = sorted(p.name for p in (a / "wav").iterdir())
    assert names == sorted(p.name for p in (b / "wav").iterdir()) and len(names) == 9
    for n in names:
        assert (a / "wav" / n).read_bytes() == (b / "wav" / n).read_bytes(), n
        m = n.replace("audio-", "mel-")
        if mel_tol == 0:
            assert (a / "mels" / m).read_bytes() == (b / "mels" / m).read_bytes(), m
        else:
            np.testing.assert_allclose(np.load(a / "mels" / m), np.load(b / "mels" / m),
                                       atol=mel_tol, err_msg=m)


def test_audio_pass_on_the_card_matches_its_cpu_route(dev, tmp_path):
    """One K6 launch an utterance; the mels within K6's tolerance (2e-4 on
    the normalised scale) of the plain route's, four threads equal to one
    in bits."""
    root = _write_preprocess_corpus(tmp_path / "corpus")
    torch.cuda.synchronize()
    before = dict(_build.launch_counts)
    assert _audio_pass(root, tmp_path / "card", dev, 1) == 9
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
                if v != before.get(k, 0)}
    assert launched == {"mel_project": 9}
    assert _audio_pass(root, tmp_path / "card4", dev, 4) == 9
    _assert_audio_passes_agree(tmp_path / "card", tmp_path / "card4", 0)
    assert _audio_pass(root, tmp_path / "cpu", "cpu", 1) == 9
    _assert_audio_passes_agree(tmp_path / "card", tmp_path / "cpu", 2e-4)


def test_embedding_pass_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch):
    """Three K3 launches an utterance (the encoder's three LSTM layers); the
    embeddings within K3's tolerance (1e-4 by ``rel_err``) of the encoder on
    the CPU with the same weights, four threads equal to one in bits."""
    import shutil

    from rtvc_tpu_torch.data.synthesizer_preprocess import create_embeddings
    from rtvc_tpu_torch.inference import encoder as tenc

    for name in ("_model", "_model_cfg", "_data"):
        monkeypatch.setattr(tenc, name, getattr(tenc, name))
    root = _write_preprocess_corpus(tmp_path / "corpus")
    assert _audio_pass(root, tmp_path / "syn", dev, 2) == 9
    model = factories.init_encoder_model(seed=4, device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for label, device, threads in (("card", dev, 1), ("card4", dev, 4), ("cpu", "cpu", 2)):
        shutil.copytree(tmp_path / "syn", tmp_path / label)
        tenc.load_state(state, device=device)
        torch.cuda.synchronize()
        before = _build.launch_counts["lstm_seq"]
        assert create_embeddings(tmp_path / label, None, n_processes=threads) == 9
        torch.cuda.synchronize()
        if label == "card":
            assert _build.launch_counts["lstm_seq"] - before == 27
        out[label] = {p.name: np.load(p) for p in (tmp_path / label / "embeds").iterdir()}
    assert out["card"].keys() == out["card4"].keys() == out["cpu"].keys()
    for n, e in out["card"].items():
        assert e.tobytes() == out["card4"][n].tobytes(), n
        assert rel_err(torch.from_numpy(e), torch.from_numpy(out["cpu"][n])) <= 1e-4, n


def test_audio_pass_builds_the_kernels_once_from_four_threads(dev, tmp_path, monkeypatch):
    """A cold kernel layer (no library loaded, an empty build directory):
    the audio pass's four threads reach K6 at once, one nvcc per source and
    one link build the library, and the files equal a one-thread run's."""
    from rtvc_tpu_torch.ops import mel_project

    root = _write_preprocess_corpus(tmp_path / "corpus")
    assert _audio_pass(root, tmp_path / "warm", dev, 1) == 9
    started, real_popen = [], _build.subprocess.Popen

    def popen(cmd, *args, **kw):  # subprocess.run goes through it too: the link
        started.append(list(cmd))
        return real_popen(cmd, *args, **kw)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_limits", {})
    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    mel_project._prepared.cache_clear()
    try:
        assert _audio_pass(root, tmp_path / "cold", dev, 4) == 9
        torch.cuda.synchronize()
    finally:
        mel_project._prepared.cache_clear()
    cu, _ = _build._sources()
    compiled = sorted(Path(cmd[-1]).name for cmd in started if "-c" in cmd)
    assert compiled == sorted(f.name for f in cu)
    assert sum("-shared" in cmd for cmd in started) == 1 and len(started) == len(cu) + 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [_build.library_path().name]
    _assert_audio_passes_agree(tmp_path / "warm", tmp_path / "cold", 0)
