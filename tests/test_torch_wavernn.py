"""WaveRNN pieces and K1 (the sample loop) against the JAX package, at the
runtimeracer architecture and small widths (f32 on the CPU; 1e-5 for the
upsampler, folding and codecs, 1e-4 for greedy decoding as the JAX package
holds its own kernel), and a chi-square test of the plain Gumbel sampler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.ops import audio as jaudio
from rtvc_tpu.ops.pallas.wavernn_kernel import generate_core_pallas
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import audio as taudio
from rtvc_tpu_torch.ops.wavernn_generate import (
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


def test_other_variants_raise():
    d = tw.WaveRNNDims(**{**DIMS, "variant": "fatchord-wavernn"})
    with pytest.raises(NotImplementedError, match="later slice"):
        tw.WaveRNN(d)
