"""K6's band limits (``ops/mel_project.py:mel_bands``), derived on the host
from the filterbank the kernel is given, over a grid of signal configs, and
the pure-Python pieces of its launch (rows a CTA, shared memory). The
kernel itself runs only on the card (``test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu_torch.ops import mel as mel_ops
from rtvc_tpu_torch.ops import mel_project as mp


def _check_bands(basis):
    b = mp.mel_bands(basis)
    num_mels, n_bins = basis.shape
    assert all(a.shape == (num_mels,) and a.dtype == np.int32
               for a in (b.first, b.width, b.offset))
    assert b.weights.dtype == np.float32 and len(b.weights) == int(b.width.sum())
    assert np.array_equal(b.offset, np.cumsum(b.width) - b.width)
    for m in range(num_mels):
        f, w, o = int(b.first[m]), int(b.width[m]), int(b.offset[m])
        nz = np.flatnonzero(basis[m])
        if len(nz) == 0:
            assert w == 0
            continue
        # the run is exactly first to last non-zero, and every non-zero lies in it
        assert (f, f + w - 1) == (nz[0], nz[-1])
        assert np.array_equal(b.weights[o:o + w], basis[m, f:f + w])
    return b


def _banded_sum(b, mag):
    """The kernel's sum in torch: each row over its run, in bin order."""
    out = torch.zeros((len(b.first), mag.shape[1]))
    for m in range(len(b.first)):
        f, w, o = int(b.first[m]), int(b.width[m]), int(b.offset[m])
        for k in range(w):
            out[m] = out[m] + float(b.weights[o + k]) * mag[f + k]
    return out


def _dense_sum(basis, mag):
    """The dense product summed the same way, every bin in order."""
    out = torch.zeros((basis.shape[0], mag.shape[1]))
    w = torch.from_numpy(basis)
    for k in range(basis.shape[1]):
        out = out + w[:, k:k + 1] * mag[k]
    return out


@settings(max_examples=30, deadline=None)
@given(sr=st.sampled_from([8000, 16000, 22050, 24000]),
       n_fft=st.sampled_from([64, 128, 256, 512, 1024, 2048]),
       num_mels=st.integers(1, 128),
       fmin=st.floats(0.0, 400.0),
       top=st.floats(0.5, 1.0))
def test_mel_bands_cover_every_nonzero(sr, n_fft, num_mels, fmin, top):
    fmax = max(fmin + 1.0, top * sr / 2)
    basis = mel_ops.mel_filterbank(sr, n_fft, num_mels, fmin, fmax)
    b = _check_bands(basis)
    mag = torch.from_numpy(np.random.default_rng(0).random((basis.shape[1], 3),
                                                           dtype=np.float32))
    banded = _banded_sum(b, mag)
    # skipped terms are exact zeros: the banded sum in bin order is the dense
    # sum in bin order bit for bit, and both are the product up to rounding
    assert torch.equal(banded, _dense_sum(basis, mag))
    torch.testing.assert_close(banded, torch.from_numpy(basis) @ mag, atol=1e-6, rtol=1e-5)


def test_mel_bands_of_the_synthesizer_filterbank():
    basis = mel_ops.mel_filterbank(sp.sample_rate, sp.n_fft, sp.num_mels, sp.fmin, sp.fmax)
    b = _check_bands(basis)
    assert int((basis != 0).sum()) == 997 and len(b.weights) == 997
    assert (b.width.min(), b.width.max()) == (4, 37)


def test_mel_bands_of_empty_rows():
    # a filterbank too fine for its FFT leaves rows with no bin at all
    basis = mel_ops.mel_filterbank(16000, 64, 80, 40.0, 8000.0)
    assert not (basis != 0).any(axis=1).all()
    b = _check_bands(basis)
    assert (b.width == 0).any()
    zero = np.zeros((4, 10), np.float32)
    zero[2, 3:5] = 1.0
    b = _check_bands(zero)
    assert b.width.tolist() == [0, 0, 2, 0] and b.offset.tolist() == [0, 0, 0, 2]
    assert mp.shared_bytes(b, 4) == 4 * (4 + 2 * mp.FRAMES)
    assert mp.shared_bytes(mp.mel_bands(np.zeros((3, 10), np.float32)), 2) == 0
    # an empty row gives the floor: min_level → -max_abs on the symmetric scale
    pp = preprocessing.replace(symmetric_mels=True)
    mag = torch.zeros((sp.n_fft // 2 + 1, 2))
    out = mp.mel_project_normalize(mag, sp, pp)
    assert torch.equal(out, torch.full_like(out, -sp.max_abs_value))


def test_mel_rows_a_cta_fill_the_card():
    sms = 132
    assert mp.mels_per_cta(4801, 80, sms) == 8
    assert mp.mels_per_cta(302, 80, sms) == 2
    assert mp.mels_per_cta(1, 80, sms) == 1
    for T in (1, 31, 33, 302, 4801, 10000):
        mpc = mp.mels_per_cta(T, 80, sms)
        tiles = -(-T // mp.FRAMES)
        assert mpc == 1 or tiles * -(-80 // mpc) >= 2 * sms


@pytest.mark.parametrize("mpc", mp.MELS_PER_CTA)
def test_mel_shared_bytes_hold_every_group(mpc):
    basis = mel_ops.mel_filterbank(sp.sample_rate, sp.n_fft, sp.num_mels, sp.fmin, sp.fmax)
    b = mp.mel_bands(basis)
    need = 0
    for m0 in range(0, sp.num_mels, mpc):
        cols = np.flatnonzero((basis[m0:m0 + mpc] != 0).any(axis=0))
        n_w = int(b.width[m0:m0 + mpc].sum())
        need = max(need, 4 * (-(-n_w // 4) * 4 + (cols[-1] - cols[0] + 1) * mp.FRAMES))
    assert mp.shared_bytes(b, mpc) == need
