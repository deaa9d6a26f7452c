"""The vocoder's generation options against the JAX package on the CPU.

K1's three new (compute_dtype, stream_dtype) pairs: the port's plain sample
loop (``ops.wavernn_generate.wavernn_generate_core_plain`` through
``models.wavernn.generate_core``) against JAX ``generate_core_pallas`` in
interpret mode at the same pair, in every variant x head cell at the tiny
dims of ``test_torch_wavernn.py``, on bridged weights; then the whole
``wavernn_generate`` under each pair against the JAX package's own
composition (upsample → fold → ``generate_core_pallas(interpret=True)`` →
unfold → decode); then ``set_generation_options`` against JAX's
``_default_window`` and ``_gen_backend`` on the CPU platform, and the
dtypes each entry point hands K1.

Tolerances. A pair with f32 weights carries an f32 state: samples within
1e-4 (the JAX package's own kernel parity), categorical labels equal. A
pair with bf16 weights rounds the carried GRU states and the fed-back
sample to bf16, and two f32 sums a few units apart round to different bf16
values wherever they lie that close to a bf16 midpoint: each such tie moves
a state by one bf16 unit (2^-8 of it), which reaches the head's inputs as a
few 1e-4 (measured here: up to 4.9e-4, fatchord MOL; on an H100 the kernel
against its plain version: up to 1.2e-4). Those pairs hold samples within
1e-3. Where a fold's samples part beyond the tolerance, the divergence is
allowed only at a near-tie of the head's choice (``chip_smoke.py:
k1_check``'s rule: the two top classes, or mixture components, of the
port's head inputs within twice the tolerance), or at or after the first
step where the two packages' bf16 streams (hoisted from their own
upsamplers, f32 sums in different orders) round apart: there the inputs
differ by a bf16 unit. The beta head has no choice to tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.inference import vocoder as jvoc
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.ops.pallas.wavernn_kernel import generate_core_pallas
from rtvc_tpu_torch.inference import pipelined
from rtvc_tpu_torch.inference import streaming as tst
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import wavernn_generate as wg
from test_torch_stream import synth_voc  # noqa: F401  (a fixture)
from test_torch_wavernn import CELLS, _cell, _mels, _upsampled

PAIRS = [("f32", "bf16"), ("bf16", "bf16"), ("bf16", "f32")]
pairs = pytest.mark.parametrize("compute,stream", PAIRS)
cells = pytest.mark.parametrize("variant,mode", CELLS)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-4, "bf16": 1e-3}  # by compute_dtype: see the docstring


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread: these models are small, and beside the other
    test workers more OpenMP threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_streams(v, jd, jmu, jaux, stream):
    """The JAX kernel's conditioning streams as it makes them (``_hoist_aux``
    in f32, then cast), as torch tensors (B, T, width)."""
    splits = [jaux[:, :, jd.aux_dims * i:jd.aux_dims * (i + 1)] for i in range(jd.n_aux_splits)]
    pre = jw._hoist_aux(v["params"], jd, jmu, splits)
    return {k: torch.from_numpy(np.asarray(x).copy()).to(TORCH[stream])
            for k, x in pre.items() if x.ndim == 3}


def _tie_steps(ours, theirs, T):
    """Per fold, the first step where any of the two packages' streams
    differ (T where none does)."""
    B = ours["i_cond"].shape[0]
    differ = torch.zeros(B, T, dtype=torch.bool)
    for k, t in ours.items():
        differ |= (t != theirs[k]).any(dim=-1)
    return [int(torch.nonzero(r)[0]) if r.any() else T for r in differ]


def _hold(got, ref, logits, head, C, tol, ties):
    """The samples (B, T) of the port against JAX's under the rule of the
    module docstring; returns the folds that parted at a near-tie or a
    stream tie, and the largest difference before any parting."""
    parted, err = [], 0.0
    for b in range(got.shape[0]):
        if head == "categorical":
            lab = lambda x: np.rint((x + 1) * (C - 1) / 2)  # noqa: E731
            differ = lab(got[b]) != lab(ref[b])
        else:
            differ = np.abs(got[b] - ref[b]) > tol
        idx = np.nonzero(differ)[0]
        t = int(idx[0]) if len(idx) else got.shape[1]
        err = max(err, float(np.abs(got[b, :t] - ref[b, :t]).max(initial=0.0)))
        if t == got.shape[1]:
            continue
        if t >= ties[b]:
            parted.append((b, t, "stream tie"))
            continue
        assert head != "beta", f"fold {b}: beta samples part at step {t}"
        choice = logits[b, t] if head == "categorical" else logits[b, t, :C // 3]
        top2 = torch.topk(choice, 2).values
        gap = float(top2[0] - top2[1])
        assert gap <= 2 * tol, f"fold {b}: samples part at step {t} with a gap of {gap}"
        parted.append((b, t, "near-tie"))
    assert err <= (1e-6 if head == "categorical" else tol), err
    return parted, err


def _port_call(model, td, tmu, taux, compute, stream):
    """The port's plain loop on its own hoisted streams at the pair, with the
    head's inputs; the streams as it cast them."""
    with torch.no_grad():
        streams = {k: v.to(TORCH[stream]).contiguous()
                   for k, v in tw.hoist_aux(model, td, tmu, taux).items()}
        weights = {k: v.to(TORCH[compute]) for k, v in tw.step_weights(model, td).items()}
        got, logits = wg.wavernn_generate_core_plain(weights, streams, 0, argmax=True,
                                                     return_logits=True, variant=td.variant,
                                                     head=td.head)
    return got, logits, streams


@cells
@pairs
def test_plain_pair_matches_pallas_kernel(variant, mode, compute, stream):
    jd, td, v, model = _cell(variant, mode)
    jmu, jaux, tmu, taux = _upsampled((jd, td, v, model), seed=4)
    ref = np.asarray(generate_core_pallas(v, jd, jmu, jaux, jax.random.PRNGKey(1), argmax=True,
                                          interpret=True, compute_dtype=JNP[compute],
                                          stream_dtype=JNP[stream]))
    got, logits, streams = _port_call(model, td, tmu, taux, compute, stream)
    # generate_core casts as this call does and reaches the same plain loop
    with torch.no_grad():
        assert torch.equal(tw.generate_core(model, td, tmu, taux, 0, argmax=True,
                                            compute_dtype=compute, stream_dtype=stream), got)
    assert got.dtype == torch.float32 and got.shape == ref.shape and float(got.std()) > 1e-3
    ties = (_tie_steps(streams, _jax_streams(v, jd, jmu, jaux, stream), ref.shape[1])
            if stream == "bf16" else [ref.shape[1]] * ref.shape[0])
    _hold(got.numpy(), ref, logits, td.head, td.n_classes, TOL[compute], ties)


@cells
@pairs
def test_each_pair_rounds(monkeypatch, variant, mode, compute, stream):
    """A cast that did nothing would pass the parity test wherever bf16
    changes little: at the pair the head's inputs differ from the f32
    loop's beyond the f32 loops' own noise (1e-6), and the state each GRU
    step carries in is a bf16 value exactly where the weights are bf16."""
    jd, td, v, model = _cell(variant, mode)
    _, _, tmu, taux = _upsampled((jd, td, v, model), seed=4)
    _, want, _ = _port_call(model, td, tmu, taux, "f32", "f32")
    carried = []
    real_gru = wg.gru_step
    monkeypatch.setattr(wg, "gru_step", lambda xg, h, *a: carried.append(h) or real_gru(xg, h, *a))
    _, logits, streams = _port_call(model, td, tmu, taux, compute, stream)
    assert {t.dtype for t in streams.values()} == {TORCH[stream]}
    assert float((logits - want).abs().max()) > 1e-6
    moved = [h for h in carried if float(h.abs().max()) > 0]
    assert moved and all(h.dtype == torch.float32 for h in moved)
    as_bf16 = all(torch.equal(h, h.to(torch.bfloat16).float()) for h in moved)
    assert as_bf16 == (compute == "bf16")


# ---------------------------------------------------------------------------
# The whole generate path under each pair
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_kernel_pipeline(monkeypatch):
    """The JAX package's undecorated generation pipeline over
    ``generate_core_pallas(interpret=True)`` at a pair set by the test; the
    kernel's folded inputs, its streams and samples recorded."""
    record = {}

    def core(variables, d, mels_up, aux, key, argmax=False, compute_dtype=None):
        if "samples" in record:  # the replay: the port's samples through JAX's decode
            return jnp.asarray(record["samples"])
        out = generate_core_pallas(variables, d, mels_up, aux, key, argmax=True, interpret=True,
                                   compute_dtype=JNP[record["compute"]],
                                   stream_dtype=JNP[record["stream"]])
        record["jax"] = np.asarray(out)
        record["streams"] = _jax_streams(variables, d, mels_up, aux, record["stream"])
        return out

    monkeypatch.setattr(jw, "generate_core", core)
    monkeypatch.setattr(jw, "_generate_pipeline", jw._generate_pipeline.__wrapped__)
    return record


@cells
@pairs
def test_generate_pair_matches_jax_composition(jax_kernel_pipeline, monkeypatch, variant, mode,
                                               compute, stream):
    """``wavernn_generate`` at the pair: its sample loop's folds held to the
    JAX kernel's under the rule above, and its waveform equal (1e-4, the f32
    parity test's) to the JAX package's unfold and decode of the port's own
    samples."""
    jd, td, v, model = _cell(variant, mode)
    mel = _mels(seed=9, frames=21, batch=1)[0]
    rec = jax_kernel_pipeline
    rec.update(compute=compute, stream=stream)
    kw = dict(target=100, overlap=20)
    jw.wavernn_generate(v, jd, mel, jax.random.PRNGKey(0), use_pallas=False, **kw)
    seen = {}
    real_core = tw.wavernn_generate_core

    def core(weights, streams, *a, **k):
        seen["dtypes"] = wg.dtypes(weights, streams)
        seen["streams"] = streams
        out, logits = real_core(weights, streams, *a, **{**k, "return_logits": True})
        seen["samples"], seen["logits"] = out, logits
        return out

    monkeypatch.setattr(tw, "wavernn_generate_core", core)
    got = tw.wavernn_generate(model, td, mel, 0, argmax=True, compute_dtype=compute,
                              stream_dtype=stream, **kw)
    assert seen["dtypes"] == (TORCH[compute], TORCH[stream])
    ref = rec["jax"]
    ties = (_tie_steps(seen["streams"], rec["streams"], ref.shape[1])
            if stream == "bf16" else [ref.shape[1]] * ref.shape[0])
    _hold(seen["samples"].numpy(), ref, seen["logits"], td.head, td.n_classes, TOL[compute], ties)
    rec["samples"] = seen["samples"].numpy()
    want = jw.wavernn_generate(v, jd, mel, jax.random.PRNGKey(0), use_pallas=False, **kw)
    assert got.shape == want.shape == (20 * td.hop_length,)
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# set_generation_options and the entry points
# ---------------------------------------------------------------------------


class _Cfg:
    gen_target, gen_overlap = 3000, 1500


@pytest.fixture
def fresh_options(monkeypatch):
    """Both packages' options at their module defaults for the test."""
    for name in ("_target_user_set", "_overlap_user_set"):
        monkeypatch.setattr(jvoc, name, False)
    for mod in (jvoc, tvoc):
        monkeypatch.setattr(mod, "_compute_dtype", None if mod is jvoc else torch.float32)
        monkeypatch.setattr(mod, "_stream_dtype", None if mod is jvoc else torch.float32)
    monkeypatch.setattr(jvoc, "_default_target", 400)
    monkeypatch.setattr(jvoc, "_default_overlap", 160)
    monkeypatch.setattr(tvoc, "_default_target", None)
    monkeypatch.setattr(tvoc, "_default_overlap", None)


SEQUENCES = [
    [],
    [dict(target=320, overlap=128)],
    [dict(overlap=96)],
    [dict(target=500)],
    [dict(target=320, overlap=128), dict(target=None)],
    [dict(target=320, overlap=128), dict(target=None, overlap=None)],
    [dict(target=320), dict(overlap=None)],
    [dict(target=320, overlap=128), dict()],
    [dict(compute_dtype="bf16", target=240), dict(stream_dtype="bf16")],
]


@pytest.mark.parametrize("calls", SEQUENCES)
def test_options_window_and_dtypes_follow_jax(fresh_options, calls):
    """The per-knob window rule and its reset as JAX's on the CPU platform
    (its TPU-only 400 / 160 default never applies), and ``compute_dtype``
    reset by every call as JAX's is; the stream dtype kept once set."""
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    for kw in calls:
        jvoc.set_generation_options(**{k: jdt.get(v, v) if "dtype" in k else v
                                       for k, v in kw.items()})
        tvoc.set_generation_options(**kw)
    assert tvoc._default_window(_Cfg) == jvoc._default_window(_Cfg)
    _, jc, js = jvoc._gen_backend()
    tc, ts = tvoc._gen_backend()
    assert tc == TORCH["bf16" if jc == jnp.bfloat16 else "f32"]
    set_stream = any("stream_dtype" in kw for kw in calls)
    # the one difference: JAX's stream default is bf16 (its TPU kernel's), the port's f32
    assert ts == (TORCH["bf16" if js == jnp.bfloat16 else "f32"] if set_stream
                  else torch.float32)


@pytest.mark.parametrize("name,want", [("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
                                       ("f32", torch.float32), ("float32", torch.float32),
                                       ("auto", torch.float32), (None, torch.float32),
                                       (torch.bfloat16, torch.bfloat16)])
def test_option_dtype_names_resolve(fresh_options, name, want):
    tvoc.set_generation_options(compute_dtype=name, stream_dtype=name)
    assert tvoc._gen_backend() == (want, want)


def test_option_dtype_names_refused(fresh_options):
    for bad in ("f16", torch.float16, "int8"):
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            tvoc.set_generation_options(compute_dtype=bad)
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            tvoc.set_generation_options(stream_dtype=bad)


@pytest.fixture
def k1_calls(monkeypatch):
    """The dtypes of every K1 call the port's generate path makes."""
    calls = []
    real = tw.wavernn_generate_core

    def core(weights, streams, *a, **k):
        calls.append(wg.dtypes(weights, streams))
        return real(weights, streams, *a, **k)

    monkeypatch.setattr(tw, "wavernn_generate_core", core)
    return calls


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("options,want", [
    ({}, (F32, F32)), ({"stream_dtype": "bf16"}, (F32, BF16)),
    ({"compute_dtype": "bf16", "stream_dtype": "bf16"}, (BF16, BF16)),
    ({"compute_dtype": "bf16"}, (BF16, F32))])
def test_inference_entry_points_hand_k1_the_options(fresh_options, synth_voc, monkeypatch,
                                                    k1_calls, options, want):
    """``infer_waveform``, ``infer_waveforms`` and ``warmup`` take the
    options' dtypes and window to K1; the defaults are f32 and the
    checkpoint's window."""
    _, voc, _ = synth_voc
    monkeypatch.setattr(tvoc, "_bundle", None)
    tvoc.load_bundle(voc)
    tvoc.set_generation_options(target=100, overlap=25, **options)
    windows = []
    real_fold = tw.fold_with_overlap
    monkeypatch.setattr(tw, "fold_with_overlap",
                        lambda x, t, o: windows.append((t, o)) or real_fold(x, t, o))
    mel = np.random.default_rng(3).uniform(-4, 0, (80, 6)).astype(np.float32)
    wav = tvoc.infer_waveform(mel)
    wavs = tvoc.infer_waveforms([mel, mel[:, :3]])
    assert tvoc.warmup((8,)) == 1
    assert k1_calls == [want] * 3 and set(windows) == {(100, 25)}
    assert wav.shape == (5 * 200,) and [w.shape for w in wavs] == [(1000,), (400,)]
    assert np.isfinite(wav).all()


def test_entry_points_default_to_f32_and_the_checkpoint_window(fresh_options, synth_voc,
                                                                monkeypatch, k1_calls):
    _, voc, _ = synth_voc
    monkeypatch.setattr(tvoc, "_bundle", None)
    tvoc.load_bundle(voc)
    assert tvoc._default_window(voc.config) == (voc.config.gen_target, voc.config.gen_overlap)
    windows = []
    real_fold = tw.fold_with_overlap
    monkeypatch.setattr(tw, "fold_with_overlap",
                        lambda x, t, o: windows.append((t, o)) or real_fold(x, t, o))
    tvoc.infer_waveform(np.zeros((80, 4), np.float32))
    assert k1_calls == [(F32, F32)]
    assert set(windows) == {(voc.config.gen_target, voc.config.gen_overlap)}


@pytest.mark.parametrize("stream,compute", [(None, None), ("bf16", None), ("bf16", "bf16"),
                                            (None, "bf16")])
def test_streaming_functions_hand_k1_their_keywords(synth_voc, k1_calls, stream, compute):
    """``stream_vocode``, ``stream_clone`` (Tacotron, its chunks through
    ``_ChunkPost``) and ``vocode_pipelined`` take ``stream_dtype`` and
    ``compute_dtype`` to every K1 launch, f32 when left out; the chunking
    does not change with them."""
    synth, voc, embed = synth_voc
    kw = {k: v for k, v in (("stream_dtype", stream), ("compute_dtype", compute)) if v}
    want = (TORCH[compute or "f32"], TORCH[stream or "f32"])
    mel = np.random.default_rng(4).uniform(-4, 0, (80, 30)).astype(np.float32)
    chunks = list(tst.stream_vocode(voc, mel, 1, chunk_frames=12, voc_target=100,
                                    voc_overlap=25, **kw))
    assert len(chunks) == len(k1_calls) >= 2 and set(k1_calls) == {want}
    assert sum(len(c.wav) for c in chunks) == 29 * 200
    del k1_calls[:]
    clone = list(tst.stream_clone(synth, voc, "Stream it.", embed, seed=1, chunk_frames=8,
                                  post_ctx=8, voc_ctx=4, voc_target=100, voc_overlap=25,
                                  min_frames=16, **kw))
    assert len(clone) == len(k1_calls) >= 2 and set(k1_calls) == {want}
    del k1_calls[:]
    wavs = list(pipelined.vocode_pipelined(voc, [mel, mel[:, :9]], target=100, overlap=25,
                                           **kw))
    assert k1_calls == [want] * 2 and [len(w) for w in wavs] == [29 * 200, 8 * 200]


def test_bf16_streams_change_the_stream_only_slightly(synth_voc):
    """A stream's greedy sample loops at bf16 streams against f32: as many
    chunks, as many samples, and most of the loops' samples equal (the JAX
    package holds f32 against bf16-stream greedy decodes of its kernel to
    more than 0.97 agreement)."""
    _, voc, _ = synth_voc
    mel = np.random.default_rng(5).uniform(-4, 0, (80, 30)).astype(np.float32)

    def greedy(**kw):
        samples = []
        with pytest.MonkeyPatch.context() as mp:
            real = tw.generate_core
            mp.setattr(tw, "generate_core", lambda *a, **k: samples.append(
                real(*a[:5], True, *a[6:], **k)) or samples[-1])
            wavs = [c.wav for c in tst.stream_vocode(voc, mel, 1, chunk_frames=12,
                                                     voc_target=100, voc_overlap=25, **kw)]
        return wavs, torch.cat([s.reshape(-1) for s in samples])

    (a, sa), (b, sb) = greedy(), greedy(stream_dtype="bf16")
    assert [len(x) for x in a] == [len(x) for x in b] and sa.shape == sb.shape
    agree = float((sa == sb).float().mean())
    assert agree > 0.97, agree


@pytest.mark.parametrize("variant,R,F,C,head", [
    ("fatchord-wavernn", 512, 512, 1024, "categorical"), ("fatchord-wavernn", 512, 512, 30, "mol"),
    ("geneing-wavernn", 256, 128, 1024, "categorical"), ("geneing-wavernn", 256, 128, 2, "beta"),
    ("geneing-wavernn", 256, 128, 30, "mol"),
    ("runtimeracer-wavernn", 256, 256, 1024, "categorical"),
    ("runtimeracer-wavernn", 256, 256, 30, "mol")])
@pytest.mark.parametrize("B", [8, 13, 264, 600])
def test_k1_plan_at_two_byte_weights(variant, R, F, C, head, B):
    """bf16 weights take two bytes of shared memory: the same cut of the
    layers over the CTAs, the weight region half as large (rounded to 16
    bytes), and at least as many folds in the phase buffer."""
    p4, p2 = (wg.plan(variant, R, F, C, B, 132, 232448, head=head, elem=e) for e in (4, 2))
    assert p2[:5] == p4[:5] and p2.fb >= p4.fb and p2.smem < p4.smem
    assert p2.smem == wg._smem_bytes(variant, R, F, head, B, *p2[1:6], elem=2)
    weights4 = wg._smem_bytes(variant, R, F, head, 0, *p2[1:6], elem=4) - \
        wg._smem_bytes(variant, R, F, head, 0, *p2[1:6], elem=0)
    weights2 = wg._smem_bytes(variant, R, F, head, 0, *p2[1:6], elem=2) - \
        wg._smem_bytes(variant, R, F, head, 0, *p2[1:6], elem=0)
    assert 0 <= weights2 - weights4 / 2 < 16


def test_k1_plan_fits_fatchord_wider_at_two_bytes():
    """fatchord's f32 weights fill most of an H100's shared memory (its phase
    buffer stops short of 512 folds); at two bytes a weight the phase buffer
    takes every fold up to MAX_FOLD_BLOCK."""
    p4 = wg.plan("fatchord-wavernn", 512, 512, 1024, 600, 132, 232448)
    p2 = wg.plan("fatchord-wavernn", 512, 512, 1024, 600, 132, 232448, elem=2)
    assert p4.fb < wg.MAX_FOLD_BLOCK == p2.fb


def test_k1_counts_each_pair_apart():
    names = {wg.count_name(v, c, s) for v in wg.LAYERS for c in (F32, BF16) for s in (F32, BF16)}
    assert names == {*wg.COUNT_NAME.values(), *wg.PAIR_COUNT_NAME.values()}
    assert len(names) == 6


def test_k1_refuses_mixed_dtypes():
    w = {"a": torch.zeros(2), "b": torch.zeros(2, dtype=BF16)}
    with pytest.raises(ValueError, match="share one dtype"):
        wg.dtypes(w, {"i_cond": torch.zeros(1, 1, 2)})

