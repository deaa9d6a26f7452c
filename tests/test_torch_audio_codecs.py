"""The port's 16-bit and 8-bit signal codecs and the vocoder's emphasis
filters (``rtvc_tpu_torch/ops/audio.py``) against the JAX package's
(``rtvc_tpu/ops/audio.py``) on the same seeded inputs: the integer codecs
exactly, ``pre_emphasis`` and ``de_emphasis`` within 1e-6 over 4000
samples. ``pre_emphasis`` is held absolutely. The IIR ``de_emphasis`` gains
up to 1 / (1 - k), and the JAX package's f32 associative scan ends ≈ 5e-6
from the exact filter at k 0.97 (values to ≈ 9), where the port's float64
filter ends within f32 rounding: it is held within 1e-6 of the JAX
output's largest entry and within 1e-6 absolute of scipy's float64
``lfilter``."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from rtvc_tpu.ops import audio as jaudio
from rtvc_tpu_torch.ops import audio as taudio

RNG = np.random.default_rng(0)
# a 16-bit signal with both ends of the range in it
X16 = np.concatenate([[-2 ** 15, 2 ** 15 - 1, 0, -1, 255, 256],
                      RNG.integers(-2 ** 15, 2 ** 15, 4000)]).astype(np.int32)
# floats in and past [-1, 1]
WAV = np.concatenate([[-1.0, 1.0, 0.0, -1.2, 1.3, 1.0 - 2 ** -16],
                      RNG.uniform(-1.1, 1.1, 4000)]).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.int16])
def test_split_signal_is_exact(dtype):
    x = X16.astype(dtype)
    want = jaudio.split_signal(jnp.asarray(X16))
    got = taudio.split_signal(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    assert _np(got[0]).min() >= 0 and _np(got[0]).max() <= 255
    assert _np(got[1]).min() >= 0 and _np(got[1]).max() <= 255


def test_combine_signal_is_exact_and_inverts_split():
    c, f = (np.array(a) for a in jaudio.split_signal(jnp.asarray(X16)))
    want = np.asarray(jaudio.combine_signal(jnp.asarray(c), jnp.asarray(f)))
    got = _np(taudio.combine_signal(torch.from_numpy(c), torch.from_numpy(f)))
    assert np.array_equal(got, want) and np.array_equal(got, X16)


def test_encode_16bits_is_exact():
    want = np.asarray(jaudio.encode_16bits(jnp.asarray(WAV)))
    got = _np(taudio.encode_16bits(torch.from_numpy(WAV)))
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 9, 16])
def test_float_2_label_is_exact(bits):
    want = np.asarray(jaudio.float_2_label(jnp.asarray(WAV), bits))
    got = _np(taudio.float_2_label(torch.from_numpy(WAV), bits))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mu", [256, 512])
def test_encode_mu_law_is_exact(mu):
    x = np.clip(WAV, -1.0, 1.0)
    want = np.asarray(jaudio.encode_mu_law(jnp.asarray(x), mu))
    got = _np(taudio.encode_mu_law(torch.from_numpy(x), mu))
    assert np.array_equal(got, want)
    # the labels decode back near the signal, as the JAX package's do
    back = _np(taudio.decode_mu_law(torch.from_numpy(got), mu))
    assert np.abs(back - x).max() < 0.05


@pytest.mark.parametrize("k", [0.97, 0.5])
def test_emphasis_filters_match(k):
    x = WAV[:4000]
    want = np.asarray(jaudio.pre_emphasis(jnp.asarray(x), k))
    got = _np(taudio.pre_emphasis(torch.from_numpy(x), k))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want = np.asarray(jaudio.de_emphasis(jnp.asarray(x), k))
    got = _np(taudio.de_emphasis(torch.from_numpy(x), k))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    exact = scipy.signal.lfilter([1.0], [1.0, -k], x.astype(np.float64))
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)
    # de-emphasis undoes pre-emphasis
    round_trip = _np(taudio.de_emphasis(taudio.pre_emphasis(torch.from_numpy(x), k), k))
    np.testing.assert_allclose(round_trip, x, atol=1e-5, rtol=0)
