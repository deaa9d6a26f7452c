"""``rtvc_tpu_torch.parallel.generation.generate_sharded``: WaveRNN
generation with the folds split over several devices (CPU "devices" here:
each shard runs K1's plain version). In ``argmax`` mode over 2, 3 and 8
devices, with 7 folds, which none of them divides, it equals the JAX
oracle of ``tests/test_parallel.py`` (JAX ``generate_core(argmax=True)``
over the same zero-padded folds, then ``xfade_and_unfold``) on the same
carried-over weights within 1e-5, and the port's one-device path. Sampled,
the shards draw from distinct seeds, one device draws what one launch
draws, and the labels follow the head's distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy import stats

from rtvc_tpu.models import wavernn as jw
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.parallel.generation import generate_sharded

DIMS = dict(variant="runtimeracer-wavernn", mode="RAW", rnn_dims=16, fc_dims=16, bits=6,
            pad=2, upsample_factors=(2, 2, 5), feat_dims=10, compute_dims=8,
            res_out_dims=16, res_blocks=1, hop_length=20, sample_rate=1000)
TARGET, OVERLAP = 100, 40
FRAMES = 50  # 1000 samples: 7 folds of 100 + 2·40


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jd, td = jw.WaveRNNDims(**DIMS), tw.WaveRNNDims(**DIMS)
    model = factories.init_wavernn(td, seed=0, device="cpu")
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5) if name.endswith("var") else buf.normal_(0, 0.2)
    v = jw.import_torch_state({k: t.clone() for k, t in model.state_dict().items()}, jd)
    mel = np.random.default_rng(0).uniform(-1, 1, (10, FRAMES)).astype(np.float32)
    return jd, td, v, model, mel


def folds(model, td, mel):
    """The port's upsampled, folded conditioning of ``mel`` and its fold
    count."""
    with torch.no_grad():
        mu, aux, _ = tw.upsample_forward(model, td, F.pad(torch.from_numpy(mel[None]),
                                                          (td.pad, td.pad)))
    mu_f, n = tw.fold_with_overlap(mu, TARGET, OVERLAP)
    return mu_f, tw.fold_with_overlap(aux, TARGET, OVERLAP)[0], n


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_argmax_equals_the_jax_oracle_and_one_device(setup, n_dev):
    jd, td, v, model, mel = setup
    got = generate_sharded(model, td, mel, 0, ["cpu"] * n_dev, TARGET, OVERLAP, argmax=True)

    mels = jnp.pad(jnp.asarray(mel[None]), ((0, 0), (0, 0), (jd.pad, jd.pad)))
    mu, aux, _ = jw.upsample_forward(v["params"]["upsample"], v["batch_stats"]["upsample"], jd,
                                     mels, train=False)
    mu_f, n_folds = jw.fold_with_overlap(mu, TARGET, OVERLAP)
    aux_f, _ = jw.fold_with_overlap(aux, TARGET, OVERLAP)
    assert n_folds == 7 and n_folds % n_dev
    pad_to = -(-n_folds // n_dev) * n_dev
    mu_f = jnp.pad(mu_f, ((0, pad_to - n_folds), (0, 0), (0, 0)))
    aux_f = jnp.pad(aux_f, ((0, pad_to - n_folds), (0, 0), (0, 0)))
    samples = jw.generate_core(v, jd, mu_f, aux_f, jax.random.PRNGKey(1), argmax=True)
    want = np.asarray(jw.xfade_and_unfold(samples[:n_folds], TARGET, OVERLAP))
    assert got.shape == want.shape == (7 * (TARGET + OVERLAP) + OVERLAP,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    mu_t, aux_t, _ = folds(model, td, mel)
    with torch.no_grad():
        one = tw.xfade_and_unfold(tw.generate_core(model, td, mu_t, aux_t, 0, argmax=True),
                                  TARGET, OVERLAP)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5)


def test_one_device_is_one_launch_sampled_too(setup):
    _, td, _, model, mel = setup
    mu_t, aux_t, _ = folds(model, td, mel)
    with torch.no_grad():
        want = tw.xfade_and_unfold(tw.generate_core(model, td, mu_t, aux_t, 11), TARGET,
                                   OVERLAP)
    got = generate_sharded(model, td, mel, 11, ["cpu"], TARGET, OVERLAP)
    assert torch.equal(got, want)


def test_sampled_shards_follow_the_head_and_draw_apart(setup):
    """The last FC zeroed, its bias set to fixed logits: every sample is a
    draw from softmax(bias). The shards' first folds must not repeat one
    stream (each shard has its own seed), and the labels over every shard
    must pass a chi-square test."""
    _, td, _, model, _ = setup
    model = factories.init_wavernn(td, seed=0, device="cpu")
    C = td.n_classes
    logits = np.random.default_rng(6).normal(0, 1.5, C).astype(np.float32)
    with torch.no_grad():
        model.fc5.weight.zero_()
        model.fc5.bias.copy_(torch.from_numpy(logits))
    mel = np.random.default_rng(3).uniform(-1, 1, (10, 4 * FRAMES)).astype(np.float32)
    _, _, n_folds = folds(model, td, mel)
    devices = ["cpu"] * 3
    samples = generate_sharded(model, td, mel, 5, devices, TARGET, OVERLAP)
    # the cross-fades mix neighbouring folds: read each fold's own samples
    body = samples.reshape(-1)[OVERLAP:OVERLAP + n_folds * (TARGET + OVERLAP)]
    body = body.reshape(n_folds, TARGET + OVERLAP)[:, :TARGET]
    per = -(-n_folds // 3)
    assert n_folds == 29 and per == 10
    # one seed for every shard would repeat the first fold's stream
    assert not torch.equal(body[0], body[per]) and not torch.equal(body[per], body[2 * per])
    labels = np.rint((body.numpy().reshape(-1) + 1.0) * (C - 1) / 2).astype(int)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    expected = p * labels.size
    counts = np.bincount(labels, minlength=C)
    keep = expected >= 5  # pool the rare classes into one bin
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    assert stats.chisquare(obs, exp).pvalue > 1e-3

