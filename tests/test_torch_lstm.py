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
from hypothesis import given, settings
from hypothesis import strategies as st

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
from rtvc_tpu_torch.ops.lstm_seq import (
    BWD_SLICES,
    FWD_SLICES,
    WARPS,
    lstm_seq,
    lstm_seq_plain,
    plan,
)

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


# ---------------------------------------------------------------------------
# The partition of a launch over the card (no card needed: plan is pure)
# ---------------------------------------------------------------------------

H100 = (132, 232448)  # SMs, bytes of shared memory a block may opt in to


def _check_plan(B, H, sm_count, smem_limit, backward):
    p = plan(B, H, sm_count, smem_limit, backward=backward)
    # every hidden unit is owned by exactly one slice; the last may be ragged
    owners = np.zeros(H, dtype=np.int64)
    for s in range(p.slices):
        owners[s * p.units:min(H, (s + 1) * p.units)] += 1
    assert (owners == 1).all()
    assert (p.slices - 1) * p.units < H <= p.slices * p.units
    # every batch row is in exactly one group; no group is empty
    assert (p.groups - 1) * p.rows < B <= p.groups * p.rows
    # all CTAs are resident at once, one a SM, and fit its shared memory
    assert 1 <= p.groups * p.slices <= sm_count
    assert 0 < p.smem <= smem_limit
    # the weights a CTA keeps, and an instantiation that exists
    w_floats = p.units * 4 * (H if backward else -(-H // 4) * 4)
    assert p.smem >= 4 * w_floats
    many = dict(BWD_SLICES if backward else FWD_SLICES)
    assert p.nb == (many[p.units] if p.rows > WARPS else 1)
    return p


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sm_count", [16, 108, 132, 144])
@pytest.mark.parametrize("B,H", [(1, 13), (2, 40), (3, 128), (8, 768), (133, 200), (640, 768),
                                 (640, 256), (64, 1280), (5, 6), (1000, 1)])
def test_lstm_plan_covers_the_shape(B, H, sm_count, backward):
    _check_plan_or_limit(B, H, sm_count, H100[1], backward)
    if H <= 6 * sm_count:  # every instantiation's slices fit the SMs
        _check_plan(B, H, sm_count, H100[1], backward)


def _check_plan_or_limit(B, H, sm_count, smem_limit, backward):
    """A plan that covers the shape, or a refusal that names a limit below H."""
    try:
        _check_plan(B, H, sm_count, smem_limit, backward)
    except ValueError as e:
        assert "past the limit of" in str(e)
        assert H > int(str(e).split("past the limit of ")[1].split()[0])


def test_lstm_plan_at_the_encoder_shapes():
    """The speaker encoder's shapes on an H100: one row a warp at the
    inference batch; at the training batch the backward's wider slices leave
    room for two batch groups."""
    fwd8 = _check_plan(8, 768, *H100, backward=False)
    assert (fwd8.groups, fwd8.slices, fwd8.units, fwd8.nb) == (1, 128, 6, 1)
    fwd = _check_plan(640, 768, *H100, backward=False)
    assert (fwd.groups, fwd.slices, fwd.units, fwd.nb, fwd.rows) == (1, 128, 6, 4, 640)
    bwd = _check_plan(640, 768, *H100, backward=True)
    assert (bwd.groups, bwd.slices, bwd.units, bwd.nb, bwd.rows) == (2, 64, 12, 8, 320)
    assert bwd.smem == 4 * (12 * 4 * 768 + WARPS * 96)


@pytest.mark.parametrize("backward", [False, True])
def test_lstm_plan_names_the_limit(backward):
    _check_plan(4, 1280, *H100, backward)   # the widest the H100 must take
    _check_plan(4, 1320, *H100, backward)   # 10 units on each of 132 SMs
    with pytest.raises(ValueError, match="past the limit of 1320 for 132 SMs"):
        plan(4, 1321, *H100, backward=backward)
    # a card with little shared memory is bounded by that, not by its SMs
    with pytest.raises(ValueError, match="past the limit of"):
        plan(4, 768, 132, 48 * 1024, backward=backward)
    _check_plan(4, 256, 132, 48 * 1024, backward)
    with pytest.raises(ValueError, match="must be positive"):
        plan(0, 768, *H100, backward=backward)


def test_lstm_plan_limit_counts_the_forward_padding():
    """The forward pads H to a multiple of 4 in shared memory, so at a
    shared-memory boundary the limit it names is a multiple of 4 below H,
    and a width at that limit is taken."""
    with pytest.raises(ValueError, match="past the limit of 168 for 29 SMs"):
        plan(8, 170, 29, 17408, backward=False)
    _check_plan_or_limit(8, 170, 29, 17408, backward=False)
    _check_plan(8, 168, 29, 17408, backward=False)
    with pytest.raises(ValueError, match="past the limit of 168 for 29 SMs"):
        plan(8, 169, 29, 17408, backward=False)


def test_profile_lstm_variants_match_the_kernel_source():
    """``profile_lstm`` makes its variants by replacing parts of
    ``csrc/lstm_seq.cu`` with ``csrc/common.cuh`` written into it: every part
    it names must still be in the source, and every variant must differ from
    it."""
    from rtvc_tpu_torch import profile_lstm

    source = profile_lstm.flat_source("lstm_seq.cu")
    assert '#include "common.cuh"' not in source and "slice_product" in source
    made = profile_lstm.variants(source)
    assert set(made) == {"base", "no_loads", "no_weights", "no_loads_no_weights", "clock"}
    assert made["base"] == source
    assert len({*made.values()}) == len(made)
    assert profile_lstm.FIRST_LOAD not in made["no_loads_no_weights"]
    assert profile_lstm.WEIGHT_LOAD not in made["no_loads_no_weights"]
    assert made["clock"].count("clock64()") == 2
    with pytest.raises(RuntimeError, match="no longer holds"):
        profile_lstm.variants(source.replace(profile_lstm.WEIGHT_LOAD, ""))


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 4096), H=st.integers(1, 1600), sm_count=st.integers(1, 200),
       smem_kb=st.integers(16, 256), backward=st.booleans())
def test_lstm_plan_property(B, H, sm_count, smem_kb, backward):
    _check_plan_or_limit(B, H, sm_count, smem_kb * 1024, backward)
