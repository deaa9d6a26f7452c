"""K3 (LSTM sequence) and the speaker-encoder path against the JAX package:
the plain version of the kernel against ``lstm_seq_fused`` in interpret mode
and against the scan; ``SpeakerEncoder``; and the encoder inference API
(f32 on the CPU; 1e-5 for the recurrences, 1e-4 for the spectrogram path,
whose FFTs sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu_torch.config.encoder import EncoderModelParams
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu.models import layers as jl
from rtvc_tpu.models import speaker_encoder as jspk
from rtvc_tpu.ops.pallas.lstm_train_kernel import lstm_seq_fused
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.models import layers as tl
from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from rtvc_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_plain

SMALL = EncoderModelParams(model_hidden_size=32, model_embedding_size=24,
                           model_num_layers=3)
JSMALL = JEncoderModelParams(**SMALL.asdict())  # the JAX package gets its own class


def _scan(w_hh_t, xg, h0, c0):
    H = w_hh_t.shape[0]

    def step(carry, xg_t):
        h, c = carry
        g = xg_t + h @ w_hh_t
        i, f, gg, o = (g[:, k * H:(k + 1) * H] for k in range(4))
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(gg)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        return (h, c), h

    (h, c), ys = jax.lax.scan(step, (h0, c0), jnp.swapaxes(xg, 0, 1))
    return jnp.swapaxes(ys, 0, 1), h, c


@pytest.mark.parametrize("B,T,H", [(3, 12, 128), (2, 7, 16)])
def test_lstm_seq_plain_matches_fused_and_scan(B, T, H):
    rng = np.random.default_rng(0)
    xg = rng.normal(0, 1, (B, T, 4 * H)).astype(np.float32)
    w_hh = rng.uniform(-H ** -0.5, H ** -0.5, (4 * H, H)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    c0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xg, w_hh, h0, c0)]
    ys, hT, cT = lstm_seq_plain(*args)
    ys2, _, _ = lstm_seq(*args)  # CPU tensors → the plain version
    assert torch.equal(ys, ys2)
    refs = [_scan(w_hh.T, xg, h0, c0)]
    if H % 128 == 0:
        refs.append(lstm_seq_fused(jnp.asarray(w_hh.T), jnp.asarray(xg),
                                   jnp.asarray(h0), jnp.asarray(c0), True))
    for r_ys, r_h, r_c in refs:
        np.testing.assert_allclose(ys.numpy(), np.asarray(r_ys), atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(r_h), atol=1e-5)
        np.testing.assert_allclose(cT.numpy(), np.asarray(r_c), atol=1e-5)


def test_lstm_module_matches_flax():
    x = np.random.default_rng(1).standard_normal((2, 9, 5)).astype(np.float32)
    mod = jl.LSTM(hidden_size=16, num_layers=2)
    v = mod.init(jax.random.PRNGKey(0), x)
    m = tl.LSTM(5, 16, 2)
    m.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in v["params"].items()})
    y, (h, c) = m(torch.from_numpy(x))
    jy, (jh, jc) = mod.apply(v, x)
    for a, b in ((y, jy), (h, jh), (c, jc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)


def test_speaker_encoder_matches():
    frames = np.abs(np.random.default_rng(2).standard_normal((3, 20, 40))).astype(np.float32)
    mod = jspk.SpeakerEncoder(model=JSMALL)
    v = mod.init(jax.random.PRNGKey(0), frames)
    m = SpeakerEncoder(SMALL)
    m.load_state_dict(bridge.speaker_encoder_state(v))
    with torch.no_grad():
        got = m(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, np.asarray(mod.apply(v, frames)), atol=1e-5)


@pytest.fixture
def small_encoders(monkeypatch):
    """Both encoder inference modules hold the same small random model."""
    monkeypatch.setattr(jenc, "_model_cfg", JSMALL)
    monkeypatch.setattr(jenc, "_model", None)
    monkeypatch.setattr(jenc, "_params", None)
    monkeypatch.setattr(tenc, "_model", None)
    jenc.init_random_model(seed=0)
    tenc.load_state(bridge.speaker_encoder_state(jenc._params), device="cpu", model_cfg=SMALL)


def _prompt(seconds=2.5, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    env = (np.sin(2 * np.pi * 3 * t) > -0.3).astype(np.float32)
    wav = 0.2 * np.sin(2 * np.pi * 180 * t) * env + 0.005 * rng.standard_normal(n)
    return wav.astype(np.float32)


def test_encoder_inference_matches(small_encoders):
    wav = _prompt()
    pj, pt = jenc.preprocess_wav(wav), tenc.preprocess_wav(wav)
    assert pj.shape == pt.shape
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    mj, mt = jenc.wav_to_mel_spectrogram(pj), tenc.wav_to_mel_spectrogram(pj)
    assert mj.shape == mt.shape
    np.testing.assert_allclose(mt, mj, atol=1e-4)
    assert tenc.compute_partial_slices(len(pj)) == jenc.compute_partial_slices(len(pj))
    ej, et = jenc.embed_utterance(pj), tenc.embed_utterance(pj)
    np.testing.assert_allclose(et, ej, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(et), 1.0, atol=1e-5)
    sj = jenc.embed_speaker([pj, pj[: len(pj) // 2]])
    st = tenc.embed_speaker([pj, pj[: len(pj) // 2]])
    np.testing.assert_allclose(st, sj, atol=1e-4)
