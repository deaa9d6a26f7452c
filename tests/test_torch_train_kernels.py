"""The training halves of K3 (LSTM) and K4 (GRU) against the JAX package:
each plain PyTorch version against ``jax.vjp`` of the Pallas kernel in
interpret mode (f32 on the CPU, 1e-5), and ``torch.autograd.gradcheck`` of
``LSTMSeqFn`` and ``GRUSeqFn`` in float64 at tiny sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.ops.pallas import gru_train_kernel as jgru
from rtvc_tpu.ops.pallas import lstm_train_kernel as jlstm
from rtvc_tpu_torch.ops.gru_seq import (
    GRUSeqFn,
    gru_seq_bwd,
    gru_seq_bwd_plain,
    gru_seq_fwd,
    gru_seq_fwd_plain,
)
from rtvc_tpu_torch.ops.lstm_seq import (
    LSTMSeqFn,
    lstm_seq_bwd,
    lstm_seq_bwd_plain,
    lstm_seq_fwd_train,
    lstm_seq_fwd_train_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _lstm_inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xg = rng.normal(0, 1, (B, T, 4 * H)).astype(np.float32)
    w_hh = rng.uniform(-H ** -0.5, H ** -0.5, (4 * H, H)).astype(np.float32)
    h0, c0, dhT, dcT = (rng.normal(0, 0.5, (B, H)).astype(np.float32) for _ in range(4))
    dys = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    return xg, w_hh, h0, c0, dys, dhT, dcT


# T 21 is not a multiple of the TPU kernel's time tile (16), which pads it
@pytest.mark.parametrize("B,T,H", [(3, 12, 128), (2, 21, 128)])
def test_lstm_train_halves_match_fused_vjp(B, T, H):
    xg, w_hh, h0, c0, dys, dhT, dcT = _lstm_inputs(B, T, H, seed=T)
    args = (jnp.asarray(w_hh.T), jnp.asarray(xg), jnp.asarray(h0), jnp.asarray(c0))
    (jys, jh, jc), vjp = jax.vjp(lambda *a: jlstm.lstm_seq_fused(*a, True), *args)
    dw_t, dxg, dh0, dc0 = vjp((jnp.asarray(dys), jnp.asarray(dhT), jnp.asarray(dcT)))
    _, res = jlstm._lstm_fwd_rule(*args, True)
    j_cs = np.swapaxes(np.asarray(res[2])[:T, :B], 0, 1)
    j_gates = np.swapaxes(np.asarray(res[3])[:T, :B], 0, 1)

    txg, tw, th0, tc0, tdys, tdhT, tdcT = _t(xg, w_hh, h0, c0, dys, dhT, dcT)
    ys, hT, cT, cs, gates = lstm_seq_fwd_train(txg, tw, th0, tc0)  # CPU → plain
    for got, want in ((ys, jys), (hT, jh), (cT, jc), (cs, j_cs), (gates, j_gates)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    g_dxg, g_dh0, g_dc0 = lstm_seq_bwd(tdys, tdhT, tdcT, gates, cs, tc0, tw)
    for got, want in ((g_dxg, dxg), (g_dh0, dh0), (g_dc0, dc0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    leaves = [a.clone().requires_grad_() for a in (txg, tw, th0, tc0)]
    out = LSTMSeqFn.apply(*leaves)
    torch.autograd.backward(out, (tdys, tdhT, tdcT))
    for leaf, want in zip(leaves, (dxg, np.asarray(dw_t).T, dh0, dc0)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **TOL)


def _gru_inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    s = H ** -0.5
    xg = rng.normal(0, 1, (B, T, 3 * H)).astype(np.float32)
    w_hh = rng.uniform(-s, s, (3 * H, H)).astype(np.float32)
    b_hh = rng.uniform(-s, s, (3 * H,)).astype(np.float32)
    dys = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    return xg, w_hh, b_hh, dys


# H 128 (the JAX kernel's own width), and H 64, the CBHG BiGRUs' width and the
# row-resident mode's on the card, where the JAX package scans (its fused_ok
# wants H % 128 == 0) but its kernel runs in interpret mode all the same
@pytest.mark.parametrize("B,T,H", [(3, 12, 128), (2, 40, 128), (2, 12, 64), (16, 9, 64)])
def test_gru_train_halves_match_fused_vjp(B, T, H):
    xg, w_hh, b_hh, dys = _gru_inputs(B, T, H, seed=T)
    args = (jnp.asarray(w_hh.T), jnp.asarray(b_hh), jnp.asarray(xg))
    jys, vjp = jax.vjp(lambda *a: jgru.gru_seq_fused(*a, True), *args)
    dw_t, db, dxg = vjp(jnp.asarray(dys))
    _, res = jgru._gru_fwd_rule(*args, True)
    j_gates = np.swapaxes(np.asarray(res[2])[:T, :B], 0, 1)

    txg, tw, tb, tdys = _t(xg, w_hh, b_hh, dys)
    ys, gates = gru_seq_fwd(txg, tw, tb)  # CPU → plain
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **TOL)
    np.testing.assert_allclose(gates.numpy(), j_gates, **TOL)
    np.testing.assert_allclose(gru_seq_bwd(tdys, gates, ys, tw).numpy(), np.asarray(dxg),
                               **TOL)

    leaves = [a.clone().requires_grad_() for a in (txg, tw, tb)]
    GRUSeqFn.apply(*leaves).backward(tdys)
    for leaf, want in zip(leaves, (dxg, np.asarray(dw_t).T, db)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **TOL)


def test_plain_halves_are_the_wrappers_cpu_path():
    xg, w_hh, h0, c0, dys, dhT, dcT = _t(*_lstm_inputs(2, 5, 8, seed=0))
    fwd = lstm_seq_fwd_train_plain(xg, w_hh, h0, c0)
    for a, b in zip(fwd, lstm_seq_fwd_train(xg, w_hh, h0, c0)):
        assert torch.equal(a, b)
    args = (dys, dhT, dcT, fwd[4], fwd[3], c0, w_hh)
    for a, b in zip(lstm_seq_bwd_plain(*args), lstm_seq_bwd(*args)):
        assert torch.equal(a, b)
    gx, gw, gb, gdys = _t(*_gru_inputs(2, 5, 8, seed=0))
    ys, gates = gru_seq_fwd_plain(gx, gw, gb)
    assert torch.equal(gru_seq_bwd_plain(gdys, gates, ys, gw), gru_seq_bwd(gdys, gates, ys, gw))


@pytest.mark.parametrize("fn", ["lstm", "gru"])
def test_gradcheck_float64(fn):
    g = torch.Generator().manual_seed(0)
    B, T, H = 2, 4, 3

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, dtype=torch.float64) * scale).requires_grad_()

    if fn == "lstm":
        inputs = (rand(B, T, 4 * H), rand(4 * H, H, scale=0.5), rand(B, H, scale=0.5),
                  rand(B, H, scale=0.5))
        assert torch.autograd.gradcheck(LSTMSeqFn.apply, inputs)
    else:
        inputs = (rand(B, T, 3 * H), rand(3 * H, H, scale=0.5), rand(3 * H, scale=0.5))
        assert torch.autograd.gradcheck(GRUSeqFn.apply, inputs)
