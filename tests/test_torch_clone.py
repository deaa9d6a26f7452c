"""The whole clone slice at small widths: prompt → embedding → mel →
waveform through the port's public API, against the same chain of JAX
functions on the same weights (prenet dropout off, greedy vocoding).
Tolerances: embedding 1e-5, post-postnet mel 1e-4, waveform 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu_torch.config.encoder import EncoderModelParams
from rtvc_tpu_torch.config.synthesizer import TacotronParams
from rtvc_tpu_torch.config.vocoder import WaveRNNParams
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.ops import audio as jaudio
from rtvc_tpu.ops.pallas.tacotron_kernel import decode_pallas
from rtvc_tpu_torch.text import text_to_sequence
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import factories

ENC = EncoderModelParams(model_hidden_size=32, model_embedding_size=768,
                         model_num_layers=2)
SYN = TacotronParams(embed_dims=32, encoder_dims=16, decoder_dims=32, postnet_dims=16,
                     encoder_K=4, lstm_dims=32, postnet_K=4, num_highways=2,
                     max_decoder_steps=60)
VOC = WaveRNNParams(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=32,
                    res_blocks=2, gen_target=600, gen_overlap=100)
TEXT = "Clone this voice."


def _prompt(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(3 * 16000) / 16000
    env = (np.sin(2 * np.pi * 2.5 * t) > -0.4).astype(np.float32)
    wav = (0.2 * np.sin(2 * np.pi * 150 * t) + 0.1 * np.sin(2 * np.pi * 310 * t)) * env
    return (wav + 0.003 * rng.standard_normal(t.size)).astype(np.float32)


def _jax_synthesize(v, d, embed, r=2):
    """Synthesizer.synthesize_spectrograms' Tacotron branch as a chain of JAX
    functions, prenet dropout off."""
    seq = text_to_sequence(TEXT, preprocessing.cleaner_names)
    chars = np.zeros((1, 32), np.int32)
    chars[0, :len(seq)] = seq
    mods = jt._modules(d)
    x = jt._apply(mods, v, "embedding", jnp.asarray(chars))
    x = jt._prenet_nodrop(v["params"]["enc_prenet"], x, jnp.float32)
    x = jt._apply(mods, v, "enc_cbhg", x, train=False)
    e = jnp.broadcast_to(jnp.asarray(embed)[None, None, :], x.shape[:2] + (embed.size,))
    enc_seq = jnp.concatenate([x, e], axis=-1)
    enc_proj = jt._apply(mods, v, "encoder_proj", enc_seq)
    max_steps = (SYN.max_decoder_steps // r) * r
    mel, _, stops = decode_pallas(v, d, enc_seq, enc_proj,
                                  jnp.asarray((chars != 0).astype(np.float32)),
                                  jax.random.PRNGKey(0), r=r, max_steps=max_steps,
                                  dropout=False, interpret=True)
    stops = np.asarray(stops)
    fired = np.all(stops > 0.5, axis=0) & (np.arange(stops.shape[1]) * r > 10)
    n = max((int(np.argmax(fired)) + 1 if fired.any() else stops.shape[1]) * r, r)
    bucket = -(-n // 128) * 128
    buf = np.full((1, d.n_mels, bucket), -sp.max_abs_value, np.float32)
    buf[:, :, :n] = np.asarray(mel)[:, :, :n]
    linear, _ = jt._postnet(v, d, jnp.asarray(buf), False, None)
    m = np.asarray(linear)[0].T[:, :n]
    end = m.shape[1]
    while end > 1 and np.max(m[:, end - 1]) < SYN.stop_threshold:
        end -= 1
    return m[:, :end]


def _jax_vocode_greedy(v, d, mel):
    """wavernn_generate with greedy sampling, as a chain of JAX functions."""
    mels = jnp.asarray(mel / sp.max_abs_value, jnp.float32)[None]
    n = mels.shape[-1]
    bucket = -(-n // 64) * 64
    mels = jnp.pad(mels, ((0, 0), (0, 0), (0, bucket - n)), constant_values=-1.0)
    mels = jnp.pad(mels, ((0, 0), (0, 0), (d.pad, d.pad)))
    mu, aux, _ = jw.upsample_forward(v["params"]["upsample"], v["batch_stats"]["upsample"],
                                     d, mels, train=False)
    mu, _ = jw.fold_with_overlap(mu, VOC.gen_target, VOC.gen_overlap)
    aux, _ = jw.fold_with_overlap(aux, VOC.gen_target, VOC.gen_overlap)
    samples = jw.generate_core(v, d, mu, aux, jax.random.PRNGKey(0), argmax=True)
    out = jw.xfade_and_unfold(samples, VOC.gen_target, VOC.gen_overlap)
    out = jaudio.de_emphasis(jaudio.decode_mu_law(out, d.n_classes, False), 0.97)
    out = np.array(out[:(n - 1) * d.hop_length], np.float64)
    fade = min(20 * d.hop_length, len(out))
    out[-fade:] *= np.linspace(1.0, 0.0, fade)
    return out


@pytest.fixture
def models(monkeypatch):
    monkeypatch.setattr(jenc, "_model_cfg", JEncoderModelParams(**ENC.asdict()))
    monkeypatch.setattr(jenc, "_model", None)
    monkeypatch.setattr(jenc, "_params", None)
    monkeypatch.setattr(tenc, "_model", None)
    monkeypatch.setattr(tvoc, "_bundle", None)
    jenc.init_random_model(seed=1)
    tenc.load_state(bridge.speaker_encoder_state(jenc._params), device="cpu", model_cfg=ENC)

    syn = factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=2, override_hp=SYN,
                                   device="cpu")
    jd_syn = jt.TacotronDims(**syn.dims._asdict())
    v_syn = jt.import_torch_state(syn.model.state_dict(), jd_syn)
    synth = tsyn.Synthesizer()
    synth.load_bundle(syn, r=2)

    voc = factories.init_voc_model(factories.MODEL_TYPE_RUNTIMERACER, seed=3,
                                   override_hp=VOC, device="cpu")
    jd_voc = jw.WaveRNNDims(**voc.dims._asdict())
    v_voc = jw.import_torch_state(voc.model.state_dict(), jd_voc)
    tvoc.load_bundle(voc)
    return synth, (v_syn, jd_syn), (v_voc, jd_voc)


def test_clone_matches_jax_chain(models):
    synth, (v_syn, jd_syn), (v_voc, jd_voc) = models
    wav = _prompt()

    embed_j = jenc.embed_utterance(jenc.preprocess_wav(wav))
    embed_t = tenc.embed_utterance(tenc.preprocess_wav(wav))
    assert embed_t.shape == (768,)
    np.testing.assert_allclose(embed_t, embed_j, atol=1e-5)

    [mel_t] = synth.synthesize_spectrograms([TEXT], [embed_t], prenet_dropout=False)
    mel_j = _jax_synthesize(v_syn, jd_syn, embed_t)
    assert mel_t.shape == mel_j.shape and mel_t.shape[0] == 80
    np.testing.assert_allclose(mel_t, mel_j, atol=1e-4)

    wav_t = tvoc.infer_waveform(mel_t, argmax=True)
    wav_j = _jax_vocode_greedy(v_voc, jd_voc, mel_t)
    assert wav_t.shape == ((mel_t.shape[1] - 1) * 200,)
    assert np.isfinite(wav_t).all()
    np.testing.assert_allclose(wav_t, wav_j, atol=1e-4)


def test_sampled_clone_is_seeded(models):
    mel = np.random.default_rng(4).uniform(-4, 0, (80, 9)).astype(np.float32)
    tvoc.set_seed(11)
    a = tvoc.infer_waveform(mel)
    tvoc.set_seed(11)
    b = tvoc.infer_waveform(mel)
    c = tvoc.infer_waveform(mel)  # next generation of the same seed
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (8 * 200,) and np.isfinite(a).all()
