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
    MMA_BATCH,
    MMA_COLUMNS,
    MMA_KINDS,
    MMA_MIN_ROWS,
    MMA_TILE,
    WARPS,
    MmaPlan,
    Plan,
    candidates,
    cuda_core_plan,
    lstm_seq,
    lstm_seq_plain,
    mma_candidates,
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


def _check_plan(B, H, sm_count, smem_limit, backward, elem=4):
    p = plan(B, H, sm_count, smem_limit, backward=backward, elem=elem)
    if isinstance(p, MmaPlan):
        return _check_mma_plan(p, B, H, sm_count, smem_limit, backward)
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
    assert p.smem >= elem * w_floats
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


def _check_plan_or_limit(B, H, sm_count, smem_limit, backward, elem=4):
    """A plan that covers the shape, or a refusal that names a limit below H."""
    try:
        _check_plan(B, H, sm_count, smem_limit, backward, elem)
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


@pytest.mark.parametrize("B", [16, 48])
def test_lstm_plan_at_the_forward_tacotron_training_shapes(B):
    """ForwardTacotron's BiLSTM (H 512) at the schedule's batches 16 and 48:
    the forward as at the clone's one row (6 units a CTA, 86 CTAs); the
    backward in narrow slices over 128 CTAs, every warp with rows, where the
    wide ones would leave 89 SMs idle."""
    fwd = _check_plan(B, 512, *H100, backward=False)
    assert (fwd.groups, fwd.slices, fwd.units, fwd.nb, fwd.rows) == (1, 86, 6, 4, B)
    bwd = _check_plan(B, 512, *H100, backward=True)
    assert (bwd.groups, bwd.slices, bwd.units, bwd.nb, bwd.rows) == (1, 128, 4, 2, B)
    wide = [p for p in candidates(B, 512, *H100, backward=True) if p.units == 12]
    assert wide and wide[0].slices == 43


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
       smem_kb=st.integers(16, 256), backward=st.booleans(), elem=st.sampled_from([4, 2]))
def test_lstm_plan_property(B, H, sm_count, smem_kb, backward, elem):
    _check_plan_or_limit(B, H, sm_count, smem_kb * 1024, backward, elem)


# ---------------------------------------------------------------------------
# K3's tensor-core mode for bf16 streams (csrc/lstm_seq_mma.cu)
# ---------------------------------------------------------------------------

def _check_mma_plan(p, B, H, sm_count, smem_limit, backward):
    """A tensor-core plan: every hidden unit in exactly one full slice, every
    batch row in exactly one 64-row tile of its group, 4 · units a multiple
    of 8 (whole wgmma column blocks), the W slice at 2 bytes a weight (all
    the shared memory a CTA takes: the state comes through registers) within
    the limit, all CTAs resident on the SMs, and the backward's K-groups
    dividing the slices and feeding the product whole pairs of batches."""
    assert (p.units, p.tiles) in MMA_KINDS and 4 * p.units % 8 == 0
    assert H % MMA_COLUMNS == 0 and p.slices * p.units == H
    owners = np.zeros(H, dtype=np.int64)
    for s in range(p.slices):
        owners[s * p.units:(s + 1) * p.units] += 1
    assert (owners == 1).all()
    rows = p.tiles * MMA_TILE
    tiles = np.zeros(B, dtype=np.int64)
    for g in range(p.groups):
        for t in range(p.tiles):
            tiles[g * rows + t * MMA_TILE:g * rows + (t + 1) * MMA_TILE] += 1
    assert (tiles == 1).all() and (p.groups - 1) * rows < B
    assert 1 <= p.groups * p.slices <= sm_count
    assert p.smem == 2 * 4 * p.units * H <= smem_limit
    if backward:
        assert p.kgroup >= 1 and p.slices % p.kgroup == 0
        assert p.kgroup * p.units // 4 % (2 * MMA_BATCH) == 0
    else:
        assert p.kgroup == 0
    return p


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sm_count", [16, 108, 132])
@pytest.mark.parametrize("B,H", [(1, 128), (5, 384), (16, 512), (48, 512), (70, 256), (130, 768),
                                 (320, 768), (640, 768), (641, 768), (640, 512), (8, 200)])
def test_lstm_bf16_plan_covers_the_shape(B, H, sm_count, backward):
    """bf16 plans of either design cover their shape; where a tensor-core
    instantiation fits the plan takes it from the direction's threshold on,
    and below it where the CUDA-core design does not fit; where neither
    fits, the plan names the limit."""
    mma = mma_candidates(B, H, sm_count, H100[1], backward)
    core = [c for c in candidates(B, H, sm_count, H100[1], backward, 2) if isinstance(c, Plan)]
    if not mma and not core:
        with pytest.raises(ValueError, match="past the limit of"):
            plan(B, H, sm_count, H100[1], backward=backward, elem=2)
        return
    p = _check_plan(B, H, sm_count, H100[1], backward, elem=2)
    assert isinstance(p, MmaPlan) == bool(mma and (B >= MMA_MIN_ROWS[backward] or not core))


@pytest.mark.parametrize("backward", [False, True])
def test_lstm_bf16_plan_takes_the_tensor_cores_at_the_ge2e_shape(backward):
    """The GE2E step (B 640 x H 768) in bf16: 5 groups of 128 rows x 24
    slices of 32 units, 120 CTAs, 192 KB of W_hh each; the backward pools dxg
    in K-groups of 4. A DP rank's half batch keeps 120 CTAs with one tile
    each. The f32 plan at the same shape stays the CUDA-core design."""
    p = _check_plan(640, 768, *H100, backward, elem=2)
    assert isinstance(p, MmaPlan)
    assert (p.groups, p.slices, p.units, p.tiles, p.kgroup, p.smem) == (
        5, 24, 32, 2, 4 if backward else 0, 196608)
    half = _check_plan(320, 768, *H100, backward, elem=2)
    assert (half.groups, half.slices, half.units, half.tiles) == (5, 24, 32, 1)
    assert isinstance(plan(640, 768, *H100, backward=backward), Plan)


@pytest.mark.parametrize("B", [16, 48])
def test_lstm_bf16_plan_at_the_forward_tacotron_shapes(B):
    """ForwardTacotron's BiLSTM (H 512) in bf16: the backward on the tensor
    cores at both batches (64 slices of 8 units, K-groups of 4), the
    forward from the threshold on, the CUDA-core plan below it (B 16)."""
    bwd = _check_plan(B, 512, *H100, True, elem=2)
    assert isinstance(bwd, MmaPlan)
    assert (bwd.groups, bwd.slices, bwd.units, bwd.tiles, bwd.kgroup) == (1, 64, 8, 1, 4)
    fwd = _check_plan(B, 512, *H100, False, elem=2)
    if B < MMA_MIN_ROWS[0]:
        assert fwd == cuda_core_plan(B, 512, *H100, elem=2)
    else:
        assert isinstance(fwd, MmaPlan) and (fwd.slices, fwd.units, fwd.tiles) == (64, 8, 1)


@pytest.mark.parametrize("backward", [False, True])
def test_lstm_bf16_plan_falls_back_to_the_cuda_core_design(backward):
    """Where no tensor-core instantiation fits (H not a multiple of 128; a
    card whose SMs cannot hold the slices), bf16 takes exactly the plan the
    CUDA-core design gives."""
    for B, H, sms in ((8, 200, 132), (640, 768, 100), (3, 40, 132)):
        p = plan(B, H, sms, H100[1], backward=backward, elem=2)
        assert isinstance(p, Plan) and p == cuda_core_plan(B, H, sms, H100[1], backward, 2)


def test_bf16_split_carries_the_f32_state():
    """The premise of the tensor-core mode, in plain torch on seeded inputs
    at the GE2E scale: an f32 h in (-1, 1) (640 x 768) and a bf16 W_hh (3072
    x 768). hi = bf16(h) and lo = bf16(h - hi) give back h within 2^-16 of
    it; hi·Wᵀ + lo·Wᵀ in f32 gives h·Wᵀ within 1e-5 of its largest entry; a
    single bf16(h)·Wᵀ does not, which is why the kernels split."""
    rng = np.random.default_rng(23)
    h = torch.from_numpy(rng.uniform(-1, 1, (640, 768)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-768 ** -0.5, 768 ** -0.5, (3072, 768)).astype(np.float32))
    w = w.bfloat16().float()
    hi = h.bfloat16().float()
    lo = (h - hi).bfloat16().float()
    assert bool(((hi + lo - h).abs() <= 2.0 ** -16 * h.abs()).all())
    want = h @ w.t()
    tol = 1e-5 * float(want.abs().max())
    assert float((hi @ w.t() + lo @ w.t() - want).abs().max()) <= tol
    assert float((hi @ w.t() - want).abs().max()) > tol
