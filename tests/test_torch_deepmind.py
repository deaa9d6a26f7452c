"""The port's DeepMind dual-softmax WaveRNN (``rtvc_tpu_torch/models/
wavernn_deepmind.py``) against the JAX package's on the same weights (the
port's seeded model carried to JAX through ``bridge.deepmind_variables``),
at hidden 32 and 48: the teacher-forced logits and the loss within 1e-5,
the loss's gradients against ``jax.grad``'s within 1e-5 (the port's
recurrence through K4's plain forward and backward), the sampling loop's
logits reproduced by the teacher-forced pass within 1e-4 for the port's own
draws and for the JAX package's, seeds, the Gumbel-max sampler's
frequencies (chi-square over 20,000 draws), the bridge both ways, the
initialiser's bounds and a tiny overfit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from rtvc_tpu.models import wavernn_deepmind as jdm
from rtvc_tpu.ops.audio import split_signal as jsplit
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import wavernn_deepmind as tdm
from rtvc_tpu_torch.ops.audio import split_signal

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_fns(d):
    return (jax.jit(functools.partial(jdm.deepmind_forward, d=d)),
            jax.jit(jax.value_and_grad(functools.partial(jdm.deepmind_loss, d=d))))


@pytest.fixture(scope="module", params=[32, 48])
def dm(request):
    d = tdm.DeepMindDims(hidden=request.param)
    jd = jdm.DeepMindDims(hidden=request.param)
    model = factories.init_deepmind(d, seed=request.param, device="cpu")
    with torch.no_grad():  # gate biases away from zero, so that each is exercised
        g = torch.Generator().manual_seed(1)
        for name in ("bias_u", "bias_r", "bias_e"):
            getattr(model, name).uniform_(-0.5, 0.5, generator=g)
    return d, jd, model, bridge.deepmind_variables(model.state_dict())


def _labels(B, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, T)).astype(np.int32),
            rng.integers(0, 256, (B, T)).astype(np.int32))


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("B,T", [(2, 9), (3, 40)])
def test_forward_and_loss_match_jax(dm, B, T):
    d, jd, model, v = dm
    coarse, fine = _labels(B, T, B * T)
    fwd, loss_grad = _jax_fns(jd)
    jc, jf = fwd(v, coarse=jnp.asarray(coarse), fine=jnp.asarray(fine))
    c, f = torch.from_numpy(coarse).long(), torch.from_numpy(fine).long()
    with torch.no_grad():
        tc, tf = tdm.deepmind_forward(model, d, c, f)
        loss = tdm.deepmind_loss(model, d, c, f)
    assert tc.shape == tf.shape == (B, T - 1, d.quantisation)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=ATOL, rtol=0)
    jloss, _ = loss_grad(v, coarse=jnp.asarray(coarse), fine=jnp.asarray(fine))
    assert abs(float(loss) - float(jloss)) <= ATOL


def test_loss_gradients_match_jax_grad(dm):
    d, jd, model, v = dm
    coarse, fine = _labels(3, 40, 7)
    _, loss_grad = _jax_fns(jd)
    jloss, jgrads = loss_grad(v, coarse=jnp.asarray(coarse), fine=jnp.asarray(fine))
    model.zero_grad()
    loss = tdm.deepmind_loss(model, d, torch.from_numpy(coarse), torch.from_numpy(fine))
    loss.backward()
    want = bridge.deepmind_state(jgrads)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(_np(got[name]), want[name].numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    model.zero_grad()


def test_the_recurrence_is_k4s_contract(dm, monkeypatch):
    """Under grad the recurrence is one ``GRUSeqFn`` application, without
    one ``gru_seq_fwd`` call, each on K4's (xg, w_hh, b_hh); b_hh is zero
    and takes no gradient."""
    d, jd, model, v = dm
    seen = []
    real_apply, real_fwd = tdm.GRUSeqFn.apply, tdm.gru_seq_fwd

    def apply(xg, w_hh, b_hh):
        seen.append(("GRUSeqFn", xg.shape, w_hh.shape, b_hh))
        return real_apply(xg, w_hh, b_hh)

    def fwd(xg, w_hh, b_hh):
        seen.append(("gru_seq_fwd", xg.shape, w_hh.shape, b_hh))
        return real_fwd(xg, w_hh, b_hh)

    monkeypatch.setattr(tdm.GRUSeqFn, "apply", apply)
    monkeypatch.setattr(tdm, "gru_seq_fwd", fwd)
    c, f = (torch.from_numpy(a).long() for a in _labels(2, 9, 3))
    tdm.deepmind_loss(model, d, c, f).backward()
    with torch.no_grad():
        tdm.deepmind_forward(model, d, c, f)
    H = d.hidden
    assert [s[:3] for s in seen] == [("GRUSeqFn", (2, 8, 3 * H), (3 * H, H)),
                                     ("gru_seq_fwd", (2, 8, 3 * H), (3 * H, H))]
    for *_, b_hh in seen:
        assert not b_hh.requires_grad and not b_hh.any()
    model.zero_grad()


def test_generated_logits_match_teacher_forced(dm):
    """The port's sampling loop and its K4 pass are the same network: the
    drawn labels, teacher-forced, reproduce the logits each was drawn
    from."""
    d, jd, model, v = dm
    g = torch.Generator().manual_seed(3)
    wav, cs, fs, lcs, lfs = tdm.deepmind_generate(model, d, 17, batch=2, generator=g,
                                                  return_logits=True)
    assert wav.shape == cs.shape == fs.shape == (2, 17)
    assert lcs.shape == lfs.shape == (2, 17, d.quantisation)
    assert float(wav.abs().max()) <= 1.0
    zero = torch.zeros((2, 1), dtype=cs.dtype)
    with torch.no_grad():
        lc, lf = tdm.deepmind_forward(model, d, torch.cat([zero, cs], 1),
                                      torch.cat([zero, fs], 1))
    np.testing.assert_allclose(_np(lc), _np(lcs), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(lf), _np(lfs), atol=1e-4, rtol=0)
    # the labels are the waveform's bytes
    assert torch.equal(torch.stack(split_signal((wav * 2 ** 15).round().long())),
                       torch.stack([cs, fs]))


def test_jax_draws_through_the_port_give_the_jax_logits(dm):
    d, jd, model, v = dm
    _, cs, fs, lcs, lfs = jdm.deepmind_generate(v, jd, jax.random.PRNGKey(5), seq_len=17,
                                                batch=2, return_logits=True)
    zero = np.zeros((2, 1), np.int64)
    with torch.no_grad():
        lc, lf = tdm.deepmind_forward(
            model, d, torch.from_numpy(np.concatenate([zero, np.asarray(cs)], 1)),
            torch.from_numpy(np.concatenate([zero, np.asarray(fs)], 1)))
    np.testing.assert_allclose(_np(lc), np.asarray(lcs), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(lf), np.asarray(lfs), atol=1e-4, rtol=0)


def test_seeds(dm):
    """The same seed gives the same waveform, through the model and through
    its state dict; another seed another waveform."""
    d, jd, model, v = dm
    a = tdm.generate(model, d, 4, seq_len=33, batch=2)
    b = tdm.generate(model.state_dict(), d, 4, seq_len=33, batch=2, device="cpu")
    c = tdm.generate(model, d, 5, seq_len=33, batch=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_sampler_matches_softmax_frequencies():
    """Gumbel-max over the generator's uniforms draws each class at its
    softmax probability: a chi-square test over 20,000 draws from fixed
    logits, at the 0.1 % level."""
    n, logits = 20000, torch.tensor([1.5, -0.5, 0.0, 2.0, -2.0, 0.7, 1.0, -1.0])
    g = torch.Generator().manual_seed(11)
    draws = tdm.categorical(logits.expand(n, -1), torch.rand((n, logits.numel()), generator=g))
    counts = np.bincount(draws.numpy(), minlength=logits.numel())
    expected = n * torch.softmax(logits.double(), 0).numpy()
    assert scipy.stats.chisquare(counts, expected).pvalue > 1e-3
    # a zero uniform is never drawn
    u = torch.full((1, 3), 0.5)
    u[0, 1] = 0.0
    assert int(tdm.categorical(torch.tensor([[0.0, 50.0, 0.0]]), u)) != 1


def test_bridge_round_trip_is_bit_exact(dm):
    d, jd, model, v = dm
    sd = model.state_dict()
    back = bridge.deepmind_state(v)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    jv = jdm.init_deepmind(jax.random.PRNGKey(0), jd)
    there = bridge.deepmind_variables(bridge.deepmind_state(jv))
    assert jax.tree_util.tree_structure(there) == jax.tree_util.tree_structure(jv)
    for a, b in zip(jax.tree_util.tree_leaves(there), jax.tree_util.tree_leaves(jv)):
        assert np.array_equal(a, np.asarray(b))
    tdm.DeepMindWaveRNN(d).load_state_dict(back, strict=True)


def test_init_bounds():
    """Every matrix and head bias within ±1/√fan_in and filling its range,
    as the JAX initialiser's; the gate biases zero; the same seed the same
    weights."""
    d = tdm.DeepMindDims(hidden=48)
    model = factories.init_deepmind(d, seed=0, device="cpu")
    fan_in = {"R": 48, "O1": 24, "O2": 24, "O3": 24, "O4": 24, "I_coarse": 2, "I_fine": 3}
    for name, p in model.named_parameters():
        if name.startswith("bias_"):
            assert not p.any(), name
            continue
        s = fan_in[name.split(".")[0]] ** -0.5
        assert float(p.abs().max()) <= s and float(p.abs().max()) > 0.8 * s, name
    again = factories.init_deepmind(d, seed=0, device="cpu").state_dict()
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())
    jv = jdm.init_deepmind(jax.random.PRNGKey(0), jdm.DeepMindDims(hidden=48))
    assert {k: tuple(v.shape) for k, v in bridge.deepmind_state(jv).items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_without_a_device_it_needs_a_card():
    d = tdm.DeepMindDims(hidden=32)
    if not torch.cuda.is_available():  # no device named: the card, or an error
        with pytest.raises(RuntimeError, match="CUDA"):
            factories.init_deepmind(d)
        state = factories.init_deepmind(d, device="cpu").state_dict()
        with pytest.raises(RuntimeError, match="CUDA"):
            tdm.generate(state, d, 0, seq_len=4)


def test_overfit_tiny_sine():
    """The dual softmax drives both 8-bit heads onto a deterministic
    waveform (the JAX package's test at hidden 48: Adam 3e-3, 120 steps, the
    last loss under 0.4 x the first)."""
    d = tdm.DeepMindDims(hidden=48)
    model = factories.init_deepmind(d, seed=0, device="cpu").train()
    t = np.arange(260)
    wav = (0.7 * np.sin(2 * np.pi * t / 13)).astype(np.float32)
    coarse, fine = split_signal(torch.from_numpy(np.round(wav * (2 ** 15 - 1)).astype(np.int32)))
    coarse, fine = coarse.view(2, 130).long(), fine.view(2, 130).long()
    assert torch.equal(coarse.flatten(), torch.from_numpy(np.array(jsplit(
        jnp.asarray(np.round(wav * (2 ** 15 - 1)).astype(np.int32)))[0])).long())
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = []
    for _ in range(120):
        opt.zero_grad()
        loss = tdm.deepmind_loss(model, d, coarse, fine)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < 0.4 * losses[0], (losses[0], losses[-1])
