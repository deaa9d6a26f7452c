"""``rtvc_tpu_torch.utils.genquality`` against ``rtvc_tpu.utils.genquality``
on the CPU: ``fold_fidelity`` on bridged tiny WaveRNNs (the port's greedy
decodes through its plain K1, the JAX package's through its scan, or through
its Pallas kernel in interpret mode at bf16 streams), the join metrics on
the same numpy waveforms, and the mel distances on the same numpy wavs.
Tolerance: 1e-5 relative (f32 sums in other orders; measured within 1e-6),
and 1e-6 absolute for ``aligned_rms``, a share of the signal's RMS that a
continuous head's f32 noise (≈ 1e-6 of a sample) moves where the share
itself is near 0 (geneing's beta head: 5.3e-5); the numpy join metrics
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config import preprocessing as jpp
from rtvc_tpu.config import sp as jsp
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.ops.pallas.wavernn_kernel import generate_core_pallas
from rtvc_tpu.utils import genquality as jg
from rtvc_tpu_torch.config import preprocessing as tpp
from rtvc_tpu_torch.config import sp as tsp
from rtvc_tpu_torch.utils import genquality as tg
from test_torch_wavernn import _cell, _mels

CONFIGS = [(100, 20), (60, 10)]
KEYS = ("target", "overlap", "num_folds", "aligned_rms", "join_click_ratio")


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    assert len(got) == len(want) == len(CONFIGS)
    for g, w in zip(got, want):
        assert tuple(g) == KEYS and tuple(w) == KEYS
        assert [g[k] for k in KEYS[:3]] == [w[k] for k in KEYS[:3]]
        np.testing.assert_allclose(g["aligned_rms"], w["aligned_rms"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["join_click_ratio"], w["join_click_ratio"], rtol=1e-5)


@pytest.mark.parametrize("variant,mode", [("runtimeracer-wavernn", "RAW"),
                                          ("fatchord-wavernn", "MOL"),
                                          ("geneing-wavernn", "RAW")])
def test_fold_fidelity_matches_jax(variant, mode):
    jd, td, v, model = _cell(variant, mode)
    mel = _mels(seed=11, frames=30, batch=1)[0]
    got = tg.fold_fidelity(model, td, mel, CONFIGS)
    _same(got, jg.fold_fidelity(v, jd, mel, CONFIGS))
    assert got[1]["num_folds"] > got[0]["num_folds"] > 1
    assert all(r["aligned_rms"] > 0 and r["join_click_ratio"] > 0 for r in got)


def test_fold_fidelity_at_bf16_streams_matches_jax_kernel(monkeypatch):
    """The dtype keywords reach the decodes: the port at bf16 streams against
    the JAX package's fold_fidelity with its decodes through the Pallas
    kernel at bf16 streams; and the f32 readings differ from them."""
    jd, td, v, model = _cell("runtimeracer-wavernn", "RAW")
    mel = _mels(seed=11, frames=30, batch=1)[0]

    def core(variables, d, mels_up, aux, key, argmax=False, compute_dtype=None):
        return generate_core_pallas(variables, d, mels_up, aux, key, argmax=True, interpret=True,
                                    stream_dtype=jnp.bfloat16)

    monkeypatch.setattr(jw, "generate_core", core)
    got = tg.fold_fidelity(model, td, mel, CONFIGS, stream_dtype="bf16")
    _same(got, jg.fold_fidelity(v, jd, mel, CONFIGS))
    f32 = tg.fold_fidelity(model, td, mel, CONFIGS)
    assert [r["aligned_rms"] for r in f32] != [r["aligned_rms"] for r in got]


@pytest.mark.parametrize("target,overlap,folds", [(100, 20, 5), (60, 10, 9), (40, 40, 3)])
def test_join_metrics_are_the_originals(target, overlap, folds):
    rng = np.random.default_rng(folds)
    n = folds * (target + overlap) + overlap
    wav = np.cumsum(rng.standard_normal(n)).astype(np.float32) * 0.01
    ref = np.roll(wav, 2) + 0.001 * rng.standard_normal(n).astype(np.float32)
    ref_rms = float(np.sqrt(np.mean(ref ** 2))) + 1e-12
    assert tg._aligned_rms(wav, ref, folds, target, overlap, ref_rms) == \
        jg._aligned_rms(wav, ref, folds, target, overlap, ref_rms)
    assert tg._join_click_ratio(wav, folds, target, overlap) == \
        jg._join_click_ratio(wav, folds, target, overlap)


def _tone(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(len(t))
            ).astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 0.02, 0.2])
def test_mel_distances_match_jax(noise):
    a = _tone(0)
    b = (a + noise * np.random.default_rng(1).standard_normal(len(a))).astype(np.float32)
    b = b[:15000]  # the shorter length is compared
    mcd = tg.mel_cepstral_distortion(a, b, tsp, tpp, device="cpu")
    l2 = tg.mel_l2_distance(a, b, tsp, tpp, device="cpu")
    np.testing.assert_allclose(mcd, jg.mel_cepstral_distortion(a, b, jsp, jpp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(l2, jg.mel_l2_distance(a, b, jsp, jpp), rtol=1e-5, atol=1e-6)
    assert (mcd == 0.0) == (l2 == 0.0) == (noise == 0.0)


def test_mel_distances_default_to_the_card():
    """The port's rule: without a ``device`` the mels are made on the card,
    which this machine does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tg.mel_l2_distance(_tone(0), _tone(1), tsp, tpp)
