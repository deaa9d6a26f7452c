"""The port's ``GRU`` module on its K4 route (``ops.gru_seq``: the plain
versions of the kernels for CPU tensors) against ``rtvc_tpu.models.layers.GRU``
on the same weights and inputs, with and without ``lengths`` (f32 on the
CPU; tolerance 1e-5 absolute, as ``test_torch_layers.py:test_gru``), and its
gradients against autograd through a plain masked loop written here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.models import layers as jl
from rtvc_tpu_torch.models import layers as tl
from rtvc_tpu_torch.ops import gru_seq as k4
from rtvc_tpu_torch.ops import rel_err

ATOL = 1e-5
B, T, I = 3, 9, 5
# a full row, a short row and a row of one frame
LENGTHS = [9, 4, 1]


def _module(H, bidirectional, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, T, I)).astype(np.float32)
    mod = jl.GRU(H, bidirectional=bidirectional)
    v = mod.init(jax.random.PRNGKey(seed), x)
    m = tl.GRU(I, H, bidirectional=bidirectional)
    m.load_state_dict({k: torch.from_numpy(np.array(p, np.float32))
                       for k, p in v["params"].items()})
    return x, mod, v, m


@pytest.mark.parametrize("H", [8, 16])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_gru_module_matches_jax(H, bidirectional, lengths):
    x, mod, v, m = _module(H, bidirectional)
    with torch.no_grad():
        y, h = m(torch.from_numpy(x),
                 lengths=None if lengths is None else torch.tensor(lengths))
    jy, jh = mod.apply(v, x, lengths=None if lengths is None else jnp.asarray(lengths))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    # with a gradient the module takes GRUSeqFn: the same numbers
    y2, h2 = m(torch.from_numpy(x), lengths=None if lengths is None else torch.tensor(lengths))
    assert torch.equal(y2.detach(), y) and torch.equal(h2.detach(), h)


def _masked_loop(m, x, lengths):
    """The length-exact GRU as a per-step loop: pads keep the carry and
    emit zeros; the reverse direction runs over the flipped sequence."""
    mask = (torch.arange(x.shape[1])[None, :] < lengths[:, None]).to(x.dtype)

    def direction(sfx, seq, mk):
        w_ih, w_hh = getattr(m, f"weight_ih_l0{sfx}"), getattr(m, f"weight_hh_l0{sfx}")
        b_ih, b_hh = getattr(m, f"bias_ih_l0{sfx}"), getattr(m, f"bias_hh_l0{sfx}")
        h = seq.new_zeros((seq.shape[0], m.hidden_size))
        ys = []
        for t in range(seq.shape[1]):
            xr, xz, xn = (seq[:, t] @ w_ih.t() + b_ih).chunk(3, dim=-1)
            hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
            r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            h_new = (1 - z) * torch.tanh(xn + r * hn) + z * h
            h = torch.where(mk[:, t, None] > 0, h_new, h)
            ys.append(h * mk[:, t, None])
        return torch.stack(ys, dim=1), h

    fwd, h_fwd = direction("", x, mask)
    if not m.bidirectional:
        return fwd, h_fwd
    bwd, h_bwd = direction("_reverse", x.flip(1), mask.flip(1))
    return torch.cat([fwd, bwd.flip(1)], dim=-1), torch.stack([h_fwd, h_bwd])


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_gru_module_gradients_match_a_masked_loop(bidirectional, lengths):
    x, _, _, m = _module(12, bidirectional, seed=1)
    rng = np.random.default_rng(2)
    H2 = 12 * (2 if bidirectional else 1)
    dy = torch.from_numpy(rng.standard_normal((B, T, H2)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal(
        ((2, B, 12) if bidirectional else (B, 12))).astype(np.float32))
    lens = torch.tensor(lengths if lengths is not None else [T] * B)

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        m.zero_grad()
        y, h = fn(xt)
        torch.autograd.backward((y, h), (dy, dh))
        return [xt.grad] + [p.grad.clone() for p in m.parameters()]

    got = grads(lambda xt: m(xt, lengths=None if lengths is None else lens))
    want = grads(lambda xt: _masked_loop(m, xt, lens))
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-5


def test_gru_module_runs_through_the_k4_wrappers(monkeypatch):
    """Each direction is one call of K4's forward (and, with a gradient, one
    of its backward); the per-step cell is never called."""
    calls = {"fwd": 0, "bwd": 0}
    fwd_plain, bwd_plain = k4.gru_seq_fwd_plain, k4.gru_seq_bwd_plain

    def spy_fwd(*a):
        calls["fwd"] += 1
        return fwd_plain(*a)

    def spy_bwd(*a):
        calls["bwd"] += 1
        return bwd_plain(*a)

    def no_step(*a):
        raise AssertionError("the GRU module ran a per-step loop")

    monkeypatch.setattr(k4, "gru_seq_fwd_plain", spy_fwd)
    monkeypatch.setattr(k4, "gru_seq_bwd_plain", spy_bwd)
    monkeypatch.setattr(tl, "gru_step", no_step)
    x, _, _, m = _module(8, True)
    with torch.no_grad():
        m(torch.from_numpy(x), lengths=torch.tensor(LENGTHS))
    assert calls == {"fwd": 2, "bwd": 0}
    y, _ = m(torch.from_numpy(x).requires_grad_())
    y.sum().backward()
    assert calls == {"fwd": 4, "bwd": 2}
