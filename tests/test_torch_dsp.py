"""The port's synthesizer-format DSP against the JAX package (f32 on the
CPU): STFT / ISTFT (1e-4 absolute), the plain version of K6 against the
Pallas kernel in interpret mode and against ``melspectrogram`` (2e-4, the
tolerance the JAX package holds its own kernel to), the dB and
normalisation helpers (1e-5), Griffin-Lim and its fast form with the same
initial phase injected into both packages (1e-3 on the waveform after 8
iterations; 1.6e-6 and 2.5e-6 are what is found), ``inv_mel_spectrogram``, and the
``Synthesizer`` helpers' shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config import preprocessing as jpp
from rtvc_tpu.config import sp as jsp
from rtvc_tpu.ops import audio as jaudio
from rtvc_tpu.ops import mel as jmel
from rtvc_tpu.ops import stft as jstft
from rtvc_tpu.ops.pallas.mel_kernel import melspectrogram_pallas
from rtvc_tpu.ops.pallas.mel_kernel import mel_project_normalize as j_mel_project
from rtvc_tpu_torch.config import preprocessing as tpp
from rtvc_tpu_torch.config import sp as tsp
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.ops import audio as taudio
from rtvc_tpu_torch.ops import mel as tmel
from rtvc_tpu_torch.ops import stft as tstft
from rtvc_tpu_torch.ops.mel_project import mel_project_normalize, mel_project_normalize_plain

GL_ITERS = 8  # Griffin-Lim is slow on one CPU core


def _tone(n=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _noise(n=4321, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


WAVS = {"tone_16000": _tone, "noise_4321": _noise}


@pytest.mark.parametrize("n_fft,hop,win,n", [(800, 200, 800, 4321), (64, 16, 48, 1000),
                                            (400, 160, 400, 3200)])
def test_stft_and_istft_match_jax(n_fft, hop, win, n):
    y = _noise(n, seed=2)
    want = np.asarray(jstft.stft(jnp.asarray(y), n_fft, hop, win))
    got = tstft.stft(torch.from_numpy(y), n_fft, hop, win)
    assert got.shape == want.shape == (1 + n_fft // 2, tstft.num_frames(n, n_fft, hop))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        tstft.frame_signal(torch.from_numpy(y), n_fft, hop).numpy(),
        np.asarray(jstft.frame_signal(jnp.asarray(y), n_fft, hop)), atol=0)
    back = tstft.istft(got, n_fft, hop, win, length=n)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jstft.istft(jnp.asarray(want), n_fft, hop, win, length=n)),
        atol=1e-4)
    assert tstft.num_frames(n, n_fft, hop) == jstft.num_frames(n, n_fft, hop)


def test_stft_round_trip_recovers_the_signal():
    y = _tone(4000, seed=3)
    spec = tstft.stft(torch.from_numpy(y), tsp.n_fft, tsp.hop_size, tsp.win_size)
    back = tstft.istft(spec, tsp.n_fft, tsp.hop_size, tsp.win_size, length=len(y))
    np.testing.assert_allclose(back.numpy(), y, atol=1e-4)


def test_hann_window_and_filterbanks_match_jax():
    np.testing.assert_array_equal(tstft.hann_window(800, 800), jstft.hann_window(800, 800))
    np.testing.assert_array_equal(tstft.hann_window(48, 64), jstft.hann_window(48, 64))
    args = (tsp.sample_rate, tsp.n_fft, tsp.num_mels, tsp.fmin, tsp.fmax)
    np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_allclose(tmel.inv_mel_filterbank(*args), jmel.inv_mel_filterbank(*args),
                               atol=1e-6)


@pytest.mark.parametrize("wav", sorted(WAVS))
def test_mel_project_plain_matches_pallas_kernel(wav):
    """K6's plain version against the TPU kernel (interpret mode) on the
    same magnitudes, and the wrapper (plain on the CPU) the same."""
    y = taudio.preemphasis(torch.from_numpy(WAVS[wav]()), tsp.preemphasis)
    mag = taudio.stft_magnitude(y, tsp.n_fft, tsp.hop_size, tsp.win_size)
    want = np.asarray(j_mel_project(jnp.asarray(mag.numpy()), jsp, jpp, interpret=True))
    got = mel_project_normalize_plain(mag, tsp, tpp)
    assert got.shape == want.shape == (80, mag.shape[1])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert torch.equal(mel_project_normalize(mag, tsp, tpp), got)


@pytest.mark.parametrize("wav", sorted(WAVS))
def test_melspectrogram_matches_jax_and_pallas(wav):
    y = WAVS[wav]()
    got = taudio.melspectrogram(torch.from_numpy(y), tsp, tpp).numpy()
    np.testing.assert_allclose(got, np.asarray(jaudio.melspectrogram(jnp.asarray(y), jsp, jpp)),
                               atol=2e-4)
    np.testing.assert_allclose(
        got, np.asarray(melspectrogram_pallas(jnp.asarray(y), jsp, jpp, interpret=True)),
        atol=2e-4)


@pytest.mark.parametrize("symmetric,clip,normalise", [(True, True, True), (False, True, True),
                                                      (True, False, True), (True, True, False)])
def test_spectrogram_options_match_jax(symmetric, clip, normalise):
    kw = dict(symmetric_mels=symmetric, allow_clipping_in_normalization=clip,
              signal_normalization=normalise)
    jp, tp = jpp.replace(**kw), tpp.replace(**kw)
    y = 3.0 * _noise(2400, seed=4)  # loud enough to reach the clip
    # 2e-4 on the normalised scale (8 units over 100 dB) is 2.5e-3 in dB
    atol = 2e-4 if normalise else 2.5e-3
    for name in ("melspectrogram", "linearspectrogram"):
        got = getattr(taudio, name)(torch.from_numpy(y), tsp, tp).numpy()
        want = np.asarray(getattr(jaudio, name)(jnp.asarray(y), jsp, jp))
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
    S = np.random.default_rng(5).uniform(-120, 20, (7, 9)).astype(np.float32)
    norm = taudio.normalize_spectrogram(torch.from_numpy(S), tsp, tp)
    np.testing.assert_allclose(norm.numpy(),
                               np.asarray(jaudio.normalize_spectrogram(jnp.asarray(S), jsp, jp)),
                               atol=1e-5)
    np.testing.assert_allclose(
        taudio.denormalize_spectrogram(norm, tsp, tp).numpy(),
        np.asarray(jaudio.denormalize_spectrogram(jnp.asarray(norm.numpy()), jsp, jp)),
        atol=1e-4)


def test_db_and_emphasis_helpers_match_jax():
    x = np.abs(_noise(500, seed=6)) * 10.0 ** np.random.default_rng(7).uniform(-7, 1, 500)
    x = x.astype(np.float32)
    np.testing.assert_allclose(taudio.amp_to_db(torch.from_numpy(x), -100.0).numpy(),
                               np.asarray(jaudio.amp_to_db(jnp.asarray(x), -100.0)), atol=1e-4)
    db = np.random.default_rng(8).uniform(-100, 20, 200).astype(np.float32)
    np.testing.assert_allclose(taudio.db_to_amp(torch.from_numpy(db)).numpy(),
                               np.asarray(jaudio.db_to_amp(jnp.asarray(db))), rtol=1e-5)
    y = 0.1 * _noise(3000, seed=9)
    pre = taudio.preemphasis(torch.from_numpy(y), 0.97)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jaudio.preemphasis(jnp.asarray(y), 0.97)),
                               atol=1e-6)
    np.testing.assert_allclose(taudio.inv_preemphasis(pre, 0.97).numpy(),
                               np.asarray(jaudio.inv_preemphasis(jnp.asarray(pre.numpy()), 0.97)),
                               atol=1e-5)
    np.testing.assert_allclose(taudio.inv_preemphasis(pre, 0.97).numpy(), y, atol=1e-5)


@pytest.mark.parametrize("n,k", [(1, 0.97), (255, 0.97), (257, 0.97), (76600, 0.97),
                                 (5000, 0.5), (3000, 0.999), (1000, -0.9), (700, 0.0),
                                 (100, 1.0)])
def test_blocked_iir_matches_lfilter(n, k):
    """The card's de-emphasis (``iir_blocks``: a product per block of 256
    samples, the carried state a truncated geometric sum) equals scipy's
    sequential ``lfilter`` to 1e-13 of the signal in float64, at block
    edges, a 4.8 s waveform, slow and negative poles, no pole and |k| = 1;
    here on the CPU, where ``inv_preemphasis`` itself keeps ``lfilter``."""
    import scipy.signal

    x = np.random.default_rng(n).standard_normal(n)
    want = scipy.signal.lfilter([1.0], [1.0, -k], x)
    got = taudio.iir_blocks(torch.from_numpy(x), k).numpy()
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())


def _jax_with_angles(fn, angles):
    """Run a JAX Griffin-Lim with ``jax.random.uniform`` giving ``angles``."""
    orig = jax.random.uniform
    jax.random.uniform = lambda key, shape, dtype=jnp.float32, **kw: jnp.asarray(angles, dtype)
    try:
        return np.asarray(fn())
    finally:
        jax.random.uniform = orig
        # a trace made meanwhile holds these angles as constants
        jaudio.griffin_lim.clear_cache()


@pytest.mark.parametrize("name", ["griffin_lim", "fast_griffin_lim"])
def test_griffin_lim_matches_jax_with_the_same_initial_phase(name):
    mag = taudio.stft_magnitude(torch.from_numpy(_tone(6000, seed=10)), tsp.n_fft, tsp.hop_size,
                                tsp.win_size)
    angles = np.random.default_rng(11).uniform(0, 1, tuple(mag.shape)).astype(np.float32)
    # the undecorated functions: the patched draw must be traced, not cached
    jfn = getattr(jaudio, name)
    jfn = getattr(jfn, "__wrapped__", jfn)
    want = _jax_with_angles(
        lambda: jfn(jnp.asarray(mag.numpy()), jsp, GL_ITERS, jax.random.PRNGKey(0), length=6000),
        angles)
    got = getattr(taudio, name)(mag, tsp, GL_ITERS, length=6000,
                                angles=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape == (6000,)
    err = float(np.abs(got - want).max())
    assert err <= 1e-3, err
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("use_lws", [False, True])
def test_inv_mel_spectrogram_matches_jax(use_lws):
    kw = dict(griffin_lim_iters=GL_ITERS, use_lws=use_lws)
    jp, tp = jpp.replace(**kw), tpp.replace(**kw)
    y = _tone(5000, seed=12)
    mel = taudio.melspectrogram(torch.from_numpy(y), tsp, tp)
    angles = np.random.default_rng(13).uniform(0, 1, (tsp.n_fft // 2 + 1, mel.shape[1]))
    angles = angles.astype(np.float32)
    jfn = jaudio.inv_mel_spectrogram.__wrapped__
    want = _jax_with_angles(
        lambda: jfn(jnp.asarray(mel.numpy()), jsp, jp, jax.random.PRNGKey(0), length=5000), angles)
    got = taudio.inv_mel_spectrogram(mel, tsp, tp, length=5000,
                                     angles=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape == (5000,)
    assert float(np.abs(got - want).max()) <= 1e-3
    lin = taudio.linearspectrogram(torch.from_numpy(y), tsp, tp)
    jlin = jaudio.inv_linear_spectrogram.__wrapped__
    want = _jax_with_angles(
        lambda: jlin(jnp.asarray(lin.numpy()), jsp, jp, jax.random.PRNGKey(0), length=5000), angles)
    got = taudio.inv_linear_spectrogram(lin, tsp, tp, length=5000,
                                        angles=torch.from_numpy(angles)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-3


def test_griffin_lim_draws_its_phase_from_the_generator():
    mag = taudio.stft_magnitude(torch.from_numpy(_tone(2000, seed=14)), tsp.n_fft, tsp.hop_size,
                                tsp.win_size)

    def run(seed):
        return taudio.griffin_lim(mag, tsp, 2, torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_synthesizer_helpers(tmp_path, monkeypatch):
    from scipy.io import wavfile

    monkeypatch.setattr(tsyn, "preprocessing", tpp.replace(griffin_lim_iters=GL_ITERS))
    y = _tone(4000, seed=15)
    mel = tsyn.Synthesizer.make_spectrogram(y, device="cpu")
    assert mel.shape == (80, 21) and mel.dtype == np.float32
    assert np.abs(mel).max() <= tsp.max_abs_value
    wav = tsyn.Synthesizer.griffin_lim(mel, seed=3, device="cpu")
    assert wav.shape == (4000,) and np.isfinite(wav).all() and np.abs(wav).max() > 0.01
    assert np.array_equal(wav, tsyn.griffin_lim(mel, seed=3, device="cpu"))
    path = tmp_path / "tone.wav"
    wavfile.write(path, 16000, (y * 32767).astype(np.int16))
    loaded = tsyn.Synthesizer.load_preprocess_wav(path)
    assert abs(float(np.abs(loaded).max()) - tpp.rescaling_max) < 1e-6
    assert tsyn.make_spectrogram(path, device="cpu").shape == (80, 21)
    if not torch.cuda.is_available():  # no device named: the card, or an error
        with pytest.raises(RuntimeError, match="CUDA"):
            tsyn.make_spectrogram(y)
