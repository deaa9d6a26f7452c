"""The CUDA kernels against their plain PyTorch versions on the card, at
small widths and, for the training kernels, at the trainers' shapes (both
on the GPU, f32). Every test needs an NVIDIA GPU and
skips without one. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
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
    lstm_seq,
    lstm_seq_bwd,
    lstm_seq_bwd_plain,
    lstm_seq_fwd_train,
    lstm_seq_fwd_train_plain,
    lstm_seq_plain,
)
from rtvc_tpu_torch.ops import tacotron_train as tk
from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode, tacotron_decode_plain
from rtvc_tpu_torch.ops.wavernn_generate import (
    wavernn_generate_core,
    wavernn_generate_core_plain,
)

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


@pytest.mark.parametrize("B,T,H", [(3, 20, 128), (2, 9, 40)])
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


def _counted(name, fn):
    before = _build.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    return out


# small widths, odd widths (the kernels' scalar path), and the encoder
# training shape (B 640, T 160, H 768)
@pytest.mark.parametrize("B,T,H", [(3, 20, 128), (2, 9, 13), (640, 160, 768)])
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
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0, c0)]
    torch.autograd.backward(LSTMSeqFn.apply(*leaves), (dys, dhT, dcT))
    ref = [t.clone().requires_grad_() for t in (xg, w, h0, c0)]
    torch.autograd.backward(lstm_seq_plain(*ref), (dys, dhT, dcT))
    for a, b in zip(leaves, ref):
        assert rel_err(a.grad, b.grad) <= 1e-4


# small widths, odd widths, and the runtimeracer training shape (B 40,
# seq_len 1000, H 256)
@pytest.mark.parametrize("B,T,H", [(3, 20, 128), (2, 9, 13), (40, 1000, 256)])
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
    dxg = _counted("gru_seq_bwd", lambda: gru_seq_bwd(dys, gates, ys, w))
    assert rel_err(dxg, gru_seq_bwd_plain(dys, gates, ys, w)) <= 1e-4
    leaves = [t.clone().requires_grad_() for t in (xg, w, b)]
    GRUSeqFn.apply(*leaves).backward(dys)
    ref = [t.clone().requires_grad_() for t in (xg, w, b)]
    gru_seq_fwd_plain(*ref)[0].backward(dys)
    for a, r in zip(leaves, ref):
        assert rel_err(a.grad, r.grad) <= 1e-4


def test_train_kernels_reject_bad_input(dev):
    h = torch.zeros(2, 16, device=dev)
    with pytest.raises(ValueError, match="w_hh_t"):
        lstm_seq_bwd(torch.zeros(2, 5, 16, device=dev), h, h,
                     torch.zeros(2, 5, 64, device=dev), torch.zeros(2, 5, 16, device=dev),
                     h, torch.zeros(64, 15, device=dev))
    with pytest.raises(ValueError, match="f32"):
        gru_seq_fwd(torch.zeros(2, 5, 48, device=dev, dtype=torch.float64),
                    torch.zeros(48, 16, device=dev), torch.zeros(48, device=dev))


def _taco(dev, B, T=16):
    d = tt.TacotronDims(**TACO)
    model = factories.init_tacotron(d, seed=0, device=dev)
    g = torch.Generator().manual_seed(1)
    chars = torch.randint(1, 40, (B, T), generator=g)
    chars[:, T - 4:] = 0
    spk = torch.randn(B, 24, generator=g)
    with torch.no_grad():
        seq, proj = tt.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)
    mask = (chars != 0).float().to(dev)
    return model, d, seq.contiguous(), proj.contiguous(), mask


@pytest.mark.parametrize("B", [2, 11])
def test_tacotron_decode_kernel_matches_plain(dev, B):
    model, d, seq, proj, mask = _taco(dev, B)
    with torch.no_grad():
        km, ka, ks = tacotron_decode(model, d, seq, proj, mask, 0, 2, 40, dropout=False)
        pm, pa, ps = tacotron_decode_plain(model, d, seq, proj, mask, 0, 2, 40,
                                           dropout=False)
    torch.cuda.synchronize()
    assert tt.stop_iterations(ks, 2) == tt.stop_iterations(ps, 2)
    torch.testing.assert_close(km, pm, atol=1e-4, rtol=0)
    torch.testing.assert_close(ka, pa, atol=1e-5, rtol=0)
    torch.testing.assert_close(ks, ps, atol=1e-4, rtol=0)


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


def _voc(dev, B=3, T=300):
    d = tw.WaveRNNDims(**VOC)
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
    # both halves through autograd, against autograd of the plain forward
    names = ("xg_pre", "enc_seq", "enc_proj")

    def grads(fwd):
        lw = tk.TrainWeights(*(t.clone().requires_grad_() for t in w))
        lx = {k: (v.clone().requires_grad_() if k in names else v) for k, v in x.items()}
        torch.autograd.backward(fwd(lw, lx), cots)
        return [t.grad for t in lw] + [lx[k].grad for k in names]

    def plain(lw, lx):
        p_x, p_res = tk.taco_train_fwd_plain(lw, **lx)
        return p_x, p_res.ctx, p_res.scores

    for name, a, b in zip(w._fields + names, grads(lambda lw, lx: tk.taco_decoder_train(lw, **lx)),
                          grads(plain)):
        assert rel_err(a, b) <= 1e-4, name


def test_taco_train_kernels_reject_bad_input(dev):
    w, x, _ = _taco_train_case(dev, 2, 9, 3, 16, 8, 8)
    with pytest.raises(ValueError, match="enc_proj"):
        tk.taco_train_fwd(w, **{**x, "enc_proj": x["enc_proj"][:, :, :8]})
    with pytest.raises(ValueError, match="odd"):
        tk.taco_train_fwd(w._replace(mloc=w.mloc[:30]), **x)
    wide, xw, _ = _taco_train_case(dev, 1, 4, 1, 1028, 4, 4)
    with pytest.raises(ValueError, match="1024"):
        tk.taco_train_fwd(wide, **xw)
