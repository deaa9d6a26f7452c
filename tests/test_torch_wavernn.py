"""WaveRNN pieces and K1 (the sample loop) against the JAX package at small
widths (f32 on the CPU; 1e-5 for the upsampler, folding, codecs and the
teacher-forced forward, 1e-4 for greedy decoding as the JAX package holds
its own kernel): the runtimeracer pieces first, then every variant x head
cell (the plain loop against the scan and against the Pallas kernel in
interpret mode, the forward, the whole of ``wavernn_generate`` and
``wavernn_generate_batch``), the output distributions (the MOL loss and
draw, the Marsaglia-Tsang beta draw), and distribution tests of the plain
samplers."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rtvc_tpu.models import distribution as jdist
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.ops import audio as jaudio
from rtvc_tpu.ops.pallas.wavernn_kernel import generate_core_pallas
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import distribution as tdist
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import audio as taudio
from rtvc_tpu_torch.ops import wavernn_generate as wg
from rtvc_tpu_torch.ops.wavernn_generate import (
    LAYERS,
    wavernn_generate_core,
    wavernn_generate_core_plain,
)

DIMS = dict(
    variant="runtimeracer-wavernn", mode="RAW", rnn_dims=16, fc_dims=16, bits=6,
    pad=2, upsample_factors=(2, 2, 5), feat_dims=10, compute_dims=8,
    res_out_dims=16, res_blocks=1, hop_length=20, sample_rate=1000,
)


@pytest.fixture(scope="module")
def setup():
    jd, td = jw.WaveRNNDims(**DIMS), tw.WaveRNNDims(**DIMS)
    model = factories.init_wavernn(td, seed=0, device="cpu")
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5) if name.endswith("var") else buf.normal_(0, 0.2)
    v = jw.import_torch_state(model.state_dict(), jd)
    return jd, td, v, model


def _mels(seed=0, frames=12, batch=2):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, 10, frames)).astype(np.float32)


def _upsampled(setup, seed=0):
    jd, td, v, model = setup
    mels = np.pad(_mels(seed), ((0, 0), (0, 0), (2, 2)))
    jmu, jaux, _ = jw.upsample_forward(v["params"]["upsample"], v["batch_stats"]["upsample"],
                                       jd, jnp.asarray(mels), train=False)
    with torch.no_grad():
        tmu, taux, _ = tw.upsample_forward(model, td, torch.from_numpy(mels))
    return jmu, jaux, tmu, taux


def test_upsample_matches(setup):
    jmu, jaux, tmu, taux = _upsampled(setup)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), atol=1e-5)


@pytest.mark.parametrize("total,target,overlap", [(137, 20, 6), (46, 20, 6), (40, 10, 5)])
def test_fold_and_unfold_match(total, target, overlap):
    x = np.random.default_rng(1).standard_normal((1, total, 3)).astype(np.float32)
    jf, jn = jw.fold_with_overlap(jnp.asarray(x), target, overlap)
    tf, tn = tw.fold_with_overlap(torch.from_numpy(x), target, overlap)
    assert tn == jn
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    y = np.asarray(jf)[:, :, 0]
    np.testing.assert_allclose(tw.xfade_and_unfold(torch.from_numpy(y), target, overlap).numpy(),
                               np.asarray(jw.xfade_and_unfold(jnp.asarray(y), target, overlap)),
                               atol=1e-5)


def test_codecs_match():
    rng = np.random.default_rng(2)
    y = rng.uniform(-1, 1, 4000).astype(np.float32)
    labels = rng.integers(0, 1024, 100).astype(np.float32)
    np.testing.assert_allclose(taudio.decode_mu_law(torch.from_numpy(y), 1024, False).numpy(),
                               np.asarray(jaudio.decode_mu_law(jnp.asarray(y), 1024, False)),
                               atol=1e-5)
    np.testing.assert_allclose(taudio.decode_mu_law(torch.from_numpy(labels), 1024).numpy(),
                               np.asarray(jaudio.decode_mu_law(jnp.asarray(labels), 1024)),
                               atol=1e-5)
    np.testing.assert_allclose(taudio.label_2_float(torch.from_numpy(labels), 10).numpy(),
                               np.asarray(jaudio.label_2_float(jnp.asarray(labels), 10)),
                               atol=1e-6)
    x = 0.05 * y
    np.testing.assert_allclose(taudio.de_emphasis(torch.from_numpy(x), 0.97).numpy(),
                               np.asarray(jaudio.de_emphasis(jnp.asarray(x), 0.97)), atol=1e-5)


def test_greedy_loop_matches_scan_and_pallas_kernel(setup):
    jd, td, v, model = setup
    jmu, jaux, tmu, taux = _upsampled(setup, seed=4)
    key = jax.random.PRNGKey(1)
    ref_scan = np.asarray(jw.generate_core(v, jd, jmu, jaux, key, argmax=True))
    ref_kernel = np.asarray(generate_core_pallas(v, jd, jmu, jaux, key, argmax=True,
                                                 interpret=True))
    with torch.no_grad():
        got = tw.generate_core(model, td, tmu, taux, seed=0, argmax=True)
        streams = {k: t.contiguous() for k, t in tw.hoist_aux(model, td, tmu, taux).items()}
        plain = wavernn_generate_core_plain(tw.step_weights(model, td), streams, 0, argmax=True)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), ref_scan, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref_kernel, atol=1e-4)


def test_gumbel_sampler_distribution(setup):
    """Fixed logits (fc5 weight 0, bias = logits): every step draws from
    softmax(bias); the label histogram must pass a chi-square test."""
    jd, td, v, model = setup
    _, _, tmu, taux = _upsampled(setup, seed=5)
    C = td.n_classes
    logits = np.random.default_rng(6).normal(0, 1.5, C).astype(np.float32)
    with torch.no_grad():
        streams = {k: t.contiguous() for k, t in tw.hoist_aux(model, td, tmu, taux).items()}
        streams = {k: t.repeat(4, 4, 1).contiguous() for k, t in streams.items()}
        w = tw.step_weights(model, td)
        w["fc5_w"] = torch.zeros_like(w["fc5_w"])
        w["fc5_b"] = torch.from_numpy(logits)
        samples = wavernn_generate_core(w, streams, seed=7)  # CPU → plain version
    labels = np.rint((samples.numpy().reshape(-1) + 1.0) * (C - 1) / 2).astype(int)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    expected = p * labels.size
    counts = np.bincount(labels, minlength=C)
    keep = expected >= 5  # pool the rare classes into one bin
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    assert stats.chisquare(obs, exp).pvalue > 1e-3


# ---------------------------------------------------------------------------
# Every variant x head cell
# ---------------------------------------------------------------------------

CELLS = [("fatchord-wavernn", "RAW"), ("fatchord-wavernn", "MOL"), ("geneing-wavernn", "BITS"),
         ("geneing-wavernn", "RAW"), ("geneing-wavernn", "MOL"),
         ("runtimeracer-wavernn", "RAW"), ("runtimeracer-wavernn", "MOL")]
cells = pytest.mark.parametrize("variant,mode", CELLS)


@functools.lru_cache(maxsize=None)
def _cell(variant, mode):
    """JAX variables from ``init_wavernn`` (the last FC redrawn wider, so
    that greedy decoding moves) carried into the port's module through
    ``bridge.wavernn_state``."""
    kw = {**DIMS, "variant": variant, "mode": mode}
    jd, td = jw.WaveRNNDims(**kw), tw.WaveRNNDims(**kw)
    v = jw.init_wavernn(jax.random.PRNGKey(0), jd)
    last = v["params"][LAYERS[variant].fcs[-1].name]
    last["weight"] = jnp.asarray(np.random.default_rng(3).normal(0, 2.0, last["weight"].shape),
                                 jnp.float32)
    model = factories.init_wavernn(td, seed=0, device="cpu")
    model.load_state_dict(bridge.wavernn_state(v), strict=True)
    return jd, td, v, model


@cells
def test_cell_greedy_loop_matches_scan_and_pallas_kernel(variant, mode):
    jd, td, v, model = _cell(variant, mode)
    assert td.head == {"MOL": "mol", "BITS": "categorical"}.get(
        mode, "beta" if variant == "geneing-wavernn" else "categorical")
    jmu, jaux, tmu, taux = _upsampled((jd, td, v, model), seed=4)
    key = jax.random.PRNGKey(1)
    ref_scan = np.asarray(jw.generate_core(v, jd, jmu, jaux, key, argmax=True))
    ref_kernel = np.asarray(generate_core_pallas(v, jd, jmu, jaux, key, argmax=True,
                                                 interpret=True, stream_dtype=jnp.float32))
    with torch.no_grad():
        got = tw.generate_core(model, td, tmu, taux, seed=0, argmax=True).numpy()
    assert got.shape == ref_scan.shape and got.std() > 1e-3
    if td.head == "categorical":  # the same class at every step
        C = td.n_classes
        for ref in (ref_scan, ref_kernel):
            np.testing.assert_array_equal(np.rint((got + 1) * (C - 1) / 2),
                                          np.rint((ref + 1) * (C - 1) / 2))
    np.testing.assert_allclose(got, ref_scan, atol=1e-4)
    np.testing.assert_allclose(got, ref_kernel, atol=1e-4)


@cells
def test_cell_forward_matches_jax(variant, mode):
    jd, td, v, model = _cell(variant, mode)
    mels = np.pad(_mels(seed=7), ((0, 0), (0, 0), (2, 2)))
    x = np.random.default_rng(8).uniform(-1, 1, (2, 12 * td.hop_length)).astype(np.float32)
    want, jstats = jw.wavernn_forward(v, jd, jnp.asarray(x), jnp.asarray(mels), train=True)
    got, stats = tw.wavernn_forward(model, td, torch.from_numpy(x), torch.from_numpy(mels))
    assert got.shape == (2, x.shape[1], td.n_classes)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if variant == "geneing-wavernn" and mode == "BITS":  # log-probabilities
        np.testing.assert_allclose(got.detach().exp().sum(-1).numpy(), 1.0, atol=1e-5)
    want_stats = bridge.wavernn_state({"params": v["params"], "batch_stats": jstats})
    for name, value in stats.items():
        np.testing.assert_allclose(value.detach().numpy(), want_stats[name].numpy(), atol=1e-6,
                                   err_msg=name)


@pytest.fixture
def greedy_jax(monkeypatch):
    """The JAX package's generation pipelines with greedy sampling: the
    undecorated pipelines (nothing stays in a jit cache) over a
    ``generate_core`` with ``argmax=True``."""
    monkeypatch.setattr(jw, "generate_core", functools.partial(jw.generate_core, argmax=True))
    monkeypatch.setattr(jw, "_generate_pipeline", jw._generate_pipeline.__wrapped__)
    monkeypatch.setattr(jw, "_generate_batch_pipeline", jw._generate_batch_pipeline.__wrapped__)


@cells
def test_cell_generate_matches_jax(greedy_jax, variant, mode):
    jd, td, v, model = _cell(variant, mode)
    mel = _mels(seed=9, frames=21, batch=1)[0]
    kw = dict(target=100, overlap=20)
    want = jw.wavernn_generate(v, jd, mel, jax.random.PRNGKey(0), use_pallas=False, **kw)
    got = tw.wavernn_generate(model, td, mel, 0, argmax=True, **kw)
    assert got.shape == want.shape == (20 * td.hop_length,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-4)
    unbatched = tw.wavernn_generate(model, td, mel, 0, argmax=True, batched=False)
    np.testing.assert_allclose(
        unbatched, jw.wavernn_generate(v, jd, mel, jax.random.PRNGKey(0), batched=False),
        atol=1e-4)


@cells
def test_cell_generate_batch_matches_jax(greedy_jax, monkeypatch, variant, mode):
    jd, td, v, model = _cell(variant, mode)
    mels = [_mels(seed=10 + i, frames=n, batch=1)[0] for i, n in enumerate((21, 9, 70))]
    kw = dict(target=100, overlap=20)
    want = jw.wavernn_generate_batch(v, jd, mels, jax.random.PRNGKey(0), use_pallas=False, **kw)
    calls = []
    core = tw.generate_core
    monkeypatch.setattr(tw, "generate_core",
                        lambda *a, **k: calls.append(a[2].shape) or core(*a, **k))
    got = tw.wavernn_generate_batch(model, td, mels, 0, argmax=True, **kw)
    # one launch of the loop for the three utterances: 3 x 22 folds of 140 steps
    assert calls == [(66, 140, td.feat_dims)]
    for g, w, m in zip(got, want, mels):
        assert g.shape == w.shape == ((m.shape[1] - 1) * td.hop_length,)
        np.testing.assert_allclose(g, w, atol=1e-4)


@cells
def test_cell_sampled_generation_is_seeded_and_in_range(variant, mode):
    _, td, _, model = _cell(variant, mode)
    mel = _mels(seed=14, frames=9, batch=1)[0]
    a = tw.wavernn_generate(model, td, mel, 5, target=100, overlap=20)
    b = tw.wavernn_generate(model, td, mel, 5, target=100, overlap=20)
    c = tw.wavernn_generate(model, td, mel, 6, target=100, overlap=20)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.isfinite(a).all() and a.shape == (8 * td.hop_length,)


@pytest.mark.parametrize("model_type", factories.VOC_MODEL_TYPES)
@pytest.mark.parametrize("mode", [None, "RAW", "BITS", "MOL"])
def test_factory_builds_every_variant_and_head(model_type, mode):
    """The reference's state-dict names and shapes at a narrow width: the
    JAX package's own importer reads the port's state dict."""
    cfg = factories.default_config(model_type).replace(
        rnn_dims=16, fc_dims=8, compute_dims=8, res_out_dims=16, res_blocks=1)
    if mode is not None:
        cfg = cfg.replace(mode=mode)
    voc = factories.init_voc_model(model_type, seed=1, override_hp=cfg, device="cpu")
    d = voc.dims
    assert voc.model_type == d.variant == model_type and d.mode == cfg.mode
    want_c = 30 if cfg.mode == "MOL" else (
        2 if (model_type, cfg.mode) == ("geneing-wavernn", "RAW") else 1024)
    assert d.n_classes == want_c
    layers = LAYERS[model_type]
    names = {n.split(".")[0] for n, _ in voc.model.named_parameters()}
    assert names == {"upsample", "I", *(r.name for r in layers.rnns),
                     *(f.name for f in layers.fcs)}
    last = getattr(voc.model, layers.fcs[-1].name)
    assert last.weight.shape == (want_c, 8)
    v = jw.import_torch_state(voc.model.state_dict(), jw.WaveRNNDims(**d._asdict()))
    back = bridge.wavernn_state(v)
    assert set(back) == set(voc.model.state_dict())
    for name, t in voc.model.state_dict().items():
        assert torch.equal(back[name], t), name


def test_factory_refuses_unknown_types():
    with pytest.raises(NotImplementedError, match="Invalid model"):
        factories.init_voc_model("hifigan", device="cpu")
    with pytest.raises(ValueError, match="Unknown WaveRNN variant"):
        tw.WaveRNN(tw.WaveRNNDims(**{**DIMS, "variant": "other-wavernn"}))


@pytest.mark.parametrize("model_type", factories.VOC_MODEL_TYPES)
def test_infer_waveforms_batches_into_one_call(monkeypatch, model_type):
    cfg = factories.default_config(model_type).replace(
        rnn_dims=16, fc_dims=8, compute_dims=8, res_out_dims=16, res_blocks=1)
    monkeypatch.setattr(tvoc, "_bundle", None)
    tvoc.load_bundle(factories.init_voc_model(model_type, seed=2, override_hp=cfg, device="cpu"))
    calls = []
    core = tw.generate_core
    monkeypatch.setattr(tw, "generate_core", lambda *a, **k: calls.append(1) or core(*a, **k))
    rng = np.random.default_rng(15)
    mels = [rng.uniform(-4, 4, (80, n)).astype(np.float32) for n in (3, 2)]
    tvoc.set_seed(3)
    wavs = tvoc.infer_waveforms(mels, target=1800, overlap=200)
    assert len(calls) == 1 and [w.shape for w in wavs] == [(400,), (200,)]
    assert all(np.isfinite(w).all() for w in wavs)
    tvoc.set_seed(3)
    again = tvoc.infer_waveforms(mels, target=1800, overlap=200)
    assert all(np.array_equal(a, b) for a, b in zip(wavs, again))
    with pytest.raises(ValueError, match="at least 2 mel frames"):
        tvoc.infer_waveforms([mels[0][:, :1]])


# ---------------------------------------------------------------------------
# Output distributions
# ---------------------------------------------------------------------------


def test_log_sum_exp_matches_jax():
    x = np.random.default_rng(16).normal(0, 30, (4, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(tdist.log_sum_exp(torch.from_numpy(x)).numpy(),
                               np.asarray(jdist.log_sum_exp(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("reduce", [True, False])
def test_mol_loss_and_gradient_match_jax(reduce):
    rng = np.random.default_rng(17)
    y_hat = rng.normal(0, 1, (3, 30, 40)).astype(np.float32)
    y_hat[:, 20:] -= 3.0  # log-scales around e^-3, some below the floor
    y_hat[0, 20:, :5] = -40.0
    y = rng.uniform(-1, 1, (3, 40, 1)).astype(np.float32)
    y[0, :3] = [[-1.0], [1.0], [0.9995]]  # the two edge bins

    def jloss(h):
        return jnp.sum(jdist.discretized_mix_logistic_loss(h, jnp.asarray(y), reduce=reduce))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(y_hat))
    h = torch.from_numpy(y_hat).requires_grad_()
    out = tdist.discretized_mix_logistic_loss(h, torch.from_numpy(y), reduce=reduce)
    assert out.shape == (() if reduce else (3, 40, 1))
    out.sum().backward()
    np.testing.assert_allclose(float(out.detach().sum()), float(want), rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_grad).max()))


def test_mol_draw_matches_jax_with_injected_uniforms():
    rng = np.random.default_rng(18)
    y = rng.normal(0, 1, (4, 30, 50)).astype(np.float32)
    y[:, 20:] -= 3.0
    temp = rng.uniform(1e-5, 1 - 1e-5, (4, 50, 10)).astype(np.float32)
    u = rng.uniform(1e-5, 1 - 1e-5, (4, 50)).astype(np.float32)
    want = jdist.sample_from_discretized_mix_logistic(
        None, jnp.asarray(y), uniforms=(jnp.asarray(temp), jnp.asarray(u)))
    got = tdist.sample_from_discretized_mix_logistic(
        None, torch.from_numpy(y), uniforms=(torch.from_numpy(temp), torch.from_numpy(u)))
    assert got.shape == (4, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    drawn = tdist.sample_from_discretized_mix_logistic(torch.Generator().manual_seed(0),
                                                      torch.from_numpy(y))
    assert drawn.shape == (4, 50) and float(drawn.abs().max()) <= 1.0


@pytest.mark.parametrize("alpha,beta", [(2.0, 5.0), (0.5, 0.5), (4.0, 1.5), (0.7, 3.0)])
def test_marsaglia_tsang_beta_draw_matches_scipy(alpha, beta):
    """The plain beta draw (the kernel's arithmetic) against scipy's Beta:
    mean and variance within 0.01, KS statistic below 0.02."""
    n = 40000
    y_hat = torch.tensor([np.log(alpha), np.log(beta)], dtype=torch.float32).expand(n, 2)
    x = tdist.sample_from_beta_dist(torch.Generator().manual_seed(19), y_hat).numpy()
    assert x.min() >= -1.0 and x.max() <= 1.0
    x = (x.astype(np.float64) + 1.0) / 2.0
    ref = stats.beta(alpha, beta)
    assert abs(x.mean() - ref.mean()) < 0.01 and abs(x.var() - ref.var()) < 0.01
    assert stats.kstest(x, ref.cdf).statistic < 0.02


def test_beta_draw_with_injected_uniforms_matches_numpy_mirror():
    """The same seven-uniform gamma arithmetic written in numpy float64."""
    rng = np.random.default_rng(20)
    a = rng.uniform(0.2, 6.0, 500)
    U = rng.uniform(1e-7, 1 - 1e-7, (500, 7))
    ab = np.where(a < 1.0, a + 1.0, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)

    def one(u1, u2, uacc):
        x = np.sqrt(-2.0 * np.log(u1)) * np.cos(2 * np.pi * u2)
        v = (1.0 + c * x) ** 3
        ok = (v > 0.0) & (np.log(uacc) < 0.5 * x * x + d - d * v
                          + d * np.log(np.maximum(v, 1e-30)))
        return ok, d * v

    ok1, g1 = one(U[:, 0], U[:, 1], U[:, 2])
    ok2, g2 = one(U[:, 3], U[:, 4], U[:, 5])
    g = np.maximum(np.where(ok1, g1, np.where(ok2, g2, d)), 1e-12)
    want = np.where(a < 1.0, g * U[:, 6] ** (1.0 / a), g)
    got = tdist.marsaglia_tsang_gamma(torch.from_numpy(a), torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def _fixed_head(variant, mode, bias):
    """The cell's plain sample loop with the last FC's weights zeroed and
    its bias set: every step draws from the same head outputs."""
    _, td, _, model = _cell(variant, mode)
    _, _, tmu, taux = _upsampled(_cell(variant, mode), seed=5)
    last = LAYERS[variant].fcs[-1].name
    with torch.no_grad():
        streams = {k: t.repeat(8, 8, 1).contiguous()
                   for k, t in tw.hoist_aux(model, td, tmu, taux).items()}
        w = tw.step_weights(model, td)
        w[f"{last}_w"] = torch.zeros_like(w[f"{last}_w"])
        w[f"{last}_b"] = torch.from_numpy(bias)
        out = wavernn_generate_core(w, streams, seed=21, variant=variant, head=td.head)
    return out.numpy().reshape(-1).astype(np.float64)


@pytest.mark.parametrize("variant", ["fatchord-wavernn", "geneing-wavernn"])
def test_mol_sampler_distribution(variant):
    rng = np.random.default_rng(22)
    logit, mean = rng.normal(0, 1, 10), rng.uniform(-0.6, 0.6, 10)
    log_scale = rng.uniform(-4.5, -3.5, 10)
    x = _fixed_head(variant, "MOL", np.concatenate([logit, mean, log_scale]).astype(np.float32))
    pi = np.exp(logit - logit.max())
    pi /= pi.sum()

    def cdf(v):
        z = (np.asarray(v)[..., None] - mean) / np.exp(log_scale)
        return (pi / (1.0 + np.exp(-z))).sum(-1)

    assert x.size >= 15000 and np.abs(x).max() < 1.0
    assert stats.kstest(x, cdf).pvalue > 1e-3


def test_beta_sampler_distribution():
    alpha, beta = 2.5, 4.0
    x = _fixed_head("geneing-wavernn", "RAW", np.log([alpha, beta]).astype(np.float32))
    assert x.size >= 15000
    assert stats.kstest((x + 1.0) / 2.0, stats.beta(alpha, beta).cdf).pvalue > 1e-3


# ---------------------------------------------------------------------------
# K1's plan (pure Python; an H100's limits)
# ---------------------------------------------------------------------------

H100 = (132, 232448)
# (variant, R, F, C, head) of the seven cells at their default widths
K1_CELLS = [(wg.VOC_FATCHORD, 512, 512, 1024, wg.HEAD_CATEGORICAL),
            (wg.VOC_FATCHORD, 512, 512, 30, wg.HEAD_MOL),
            (wg.VOC_GENEING, 256, 128, 1024, wg.HEAD_CATEGORICAL),
            (wg.VOC_GENEING, 256, 128, 2, wg.HEAD_BETA),
            (wg.VOC_GENEING, 256, 128, 30, wg.HEAD_MOL),
            (wg.VOC_RUNTIMERACER, 256, 256, 1024, wg.HEAD_CATEGORICAL),
            (wg.VOC_RUNTIMERACER, 256, 256, 30, wg.HEAD_MOL)]


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("B", [1, 13, 169, 520, 2000])
@pytest.mark.parametrize("variant,R,F,C,head", K1_CELLS)
def test_k1_phase_buffer_holds_the_head_maxima(variant, R, F, C, head, B, elem):
    """The categorical head's second half leaves each warp's maxima, a value
    and a class for each fold of a block, in the phase buffer
    (``csrc/wavernn_generate.cu``): every plan's phase buffer has at least
    2·WARPS rows of ``fb`` folds, its GRUs' two weight blocks of at least
    ROW_BLOCK rows each."""
    p = wg.plan(variant, R, F, C, B, *H100, head=head, elem=elem)
    rows = max(2 * wg._blocks(3 * p.units), wg._blocks(max(p.fc_rows, p.last_rows)))
    assert rows >= 2 * wg.WARPS
    # the buffer as _smem_bytes counts it: one fold more of the block takes
    # a float a row, and a categorical head's partials (two a class quad)
    grown = wg._smem_bytes(variant, R, F, head, B, *p[1:5], p.fb + p.nb, elem=elem)
    quads = 2 * (p.last_rows // 4) if head == wg.HEAD_CATEGORICAL else 0
    assert grown - p.smem == 4 * p.nb * (rows + quads)


def test_k1_layout_by_hand():
    """runtimeracer RAW f32 on an H100 against the kernel's layout worked by
    hand. Weights: 4 GRUs × (W_ih and W_hh of 8 rows × 256 + 2 × 8 biases)
    + 4 i_col units + 4 FCs × (8 rows × 256 + 4) + the last FC's 8 rows ×
    256 + 8 = 26716 floats, 106864 bytes. At the paragraph's 169 folds
    (items of 8, one block of 176): W_ih·i_col 8, the warps' sums 8 × 64 =
    512, the phase buffer 16 × 176 = 2816 (the head's maxima take all 16
    rows), the partials 2 × 2 × 176 = 704, the previous samples 172: 4212
    floats, 16848 bytes. At the clone's 13 (items of 4, one block of 16):
    8 + 8 × 32 + 16 × 16 + 64 + 16 = 600 floats, 2400 bytes."""
    args = (wg.VOC_RUNTIMERACER, 256, 256, 1024)
    assert wg.plan(*args, 169, *H100) == (128, 2, 2, 8, 8, 176, 106864 + 16848)
    assert wg.plan(*args, 13, *H100) == (128, 2, 2, 8, 4, 16, 106864 + 2400)


def test_k1_plan_errors_keep_their_messages():
    with pytest.raises(ValueError, match="past the limit of 232448"):
        wg.plan(wg.VOC_FATCHORD, 1024, 1024, 1024, 169, *H100)
    with pytest.raises(ValueError, match="past the limit of 48000"):
        wg.plan(wg.VOC_RUNTIMERACER, 256, 256, 1024, 169, 132, 48000)
    with pytest.raises(ValueError, match="folds are past the limit of"):
        wg.plan(wg.VOC_GENEING, 256, 128, 1024, 200000, 132, 48000 + 4 * 4096)
    with pytest.raises(ValueError, match="bad plan inputs"):
        wg.plan(wg.VOC_GENEING, 256, 128, 1024, 0, *H100)
