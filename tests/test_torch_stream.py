"""The port's streaming clone against the JAX package at narrow widths:
K2's resumable launch (its plain twin on the CPU) against JAX
``tacotron_generate`` and the plain ``decode_loop``, the chunk postnet
against JAX ``_postnet``, ``stream_vocode``'s schedule against JAX's, the
stream's length invariant and context clamp, ``vocode_pipelined`` against
single calls, and the NAR branch. Tolerances: the decoder and the postnet
1e-5 (``tests/test_streaming.py``'s and ``test_torch_tacotron.py``'s);
everything else equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.inference import streaming as jst
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.inference import pipelined
from rtvc_tpu_torch.inference import streaming as tst
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import tacotron_decode as td
from test_torch_clone import SYN, VOC
from test_torch_fast_pitch import CFG as FP_CFG
from test_torch_forward_tacotron import CFG as FT_CFG
from test_torch_tacotron import DIMS

PAD = -4.0
TEXT = "Stream this voice, chunk by chunk."
HOP = sp.hop_size


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: these models are small, and beside the other
    test workers more OpenMP threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def taco():
    """A narrow Tacotron, its JAX variables (``bridge``d through the JAX
    importer), and two texts' characters and speaker embeddings."""
    jd, d = jt.TacotronDims(**DIMS), tt.TacotronDims(**DIMS)
    model = factories.init_tacotron(d, seed=0, device="cpu")
    v = jt.import_torch_state(model.state_dict(), jd)
    rng = np.random.default_rng(0)
    chars = np.where(np.arange(16)[None, :] < 12, rng.integers(1, 40, (2, 16)),
                     0).astype(np.int32)
    spk = rng.standard_normal((2, 24)).astype(np.float32)
    return jd, d, v, model, chars, spk


def _chunks(model, d, seq, proj, mask, cuts, dropout, g=None, min_iters=0, seed=0):
    """A decode through ``tacotron_decode_chunk`` (the plain twin here) in
    launches of ``cuts`` iterations: [(the state it was given, its
    DecodeChunk)]."""
    B, T = mask.shape
    state = (tt.init_decoder_carry(d, B, T), torch.zeros(B, d.n_mels),
             torch.zeros((), dtype=torch.int32))
    outs, start = [], 0
    with torch.no_grad():
        for n in cuts:
            out = td.tacotron_decode_chunk(model, d, seq, proj, mask, seed, 2, *state, start, n,
                                           min_iters, PAD, dropout, g)
            outs.append(((*state, start, n), out))
            state, start = (out.carry, out.prev, out.done), start + n
    return outs


@pytest.mark.parametrize("n", [3, 5])
def test_chunked_decode_matches_jax_generate(taco, n):
    """Dropout off, in launches of n iterations: the joined valid frames
    equal JAX ``tacotron_generate``'s on the same encoder outputs (JAX's
    encoder, its key split as ``tacotron_generate`` splits it)."""
    jd, d, v, model, chars, spk = taco
    max_steps = 30
    rng = jax.random.PRNGKey(7)
    j_mel, _, j_attn, j_valid = jt.tacotron_generate(v, jd, jnp.asarray(chars), jnp.asarray(spk),
                                                     2, rng, max_steps=max_steps,
                                                     prenet_dropout=False)
    k_enc, _, _ = jax.random.split(rng, 3)
    seq, proj, _ = jt.encode(v, jd, jnp.asarray(chars), jnp.asarray(spk), train=False, rng=k_enc)
    seq, proj = torch.tensor(np.asarray(seq)), torch.tensor(np.asarray(proj))
    mask = torch.from_numpy((chars != 0).astype(np.float32))
    cuts = [n] * -(-(max_steps // 2) // n)
    outs = _chunks(model, d, seq, proj, mask, cuts, False)
    valid = sum(int(o.valid) for _, o in outs)
    assert valid * 2 == int(j_valid)
    mel = torch.cat([o.mel for _, o in outs], dim=2)[:, :, :valid * 2].numpy()
    np.testing.assert_allclose(mel, np.asarray(j_mel)[:, :, :valid * 2], atol=1e-5)
    attn = torch.cat([o.attn for _, o in outs], dim=1)[:, :valid].numpy()
    np.testing.assert_allclose(attn, np.asarray(j_attn)[:, :valid], atol=1e-5)


def test_chunked_decode_equals_one_decode_loop_with_dropout(taco):
    """Dropout on, one generator through the launches: the draws of one
    ``decode_loop``, so the joined frames equal its frames exactly."""
    jd, d, v, model, chars, spk = taco
    with torch.no_grad():
        seq, proj = tt.encode(model, torch.from_numpy(chars), torch.from_numpy(spk),
                              prenet_dropout=False)
    mask = torch.from_numpy((chars != 0).astype(np.float32))
    with torch.no_grad():
        ref, ref_attn, ref_stops = tt.decode_loop(model, d, seq, proj, mask, 2, 24,
                                                  torch.Generator().manual_seed(3))
    outs = _chunks(model, d, seq, proj, mask, [3, 5, 4], True, torch.Generator().manual_seed(3))
    valid = sum(int(o.valid) for _, o in outs)
    assert valid == tt.stop_iterations(ref_stops, 2)
    assert torch.equal(torch.cat([o.mel for _, o in outs], dim=2)[:, :, :2 * valid],
                       ref[:, :, :2 * valid])
    assert torch.equal(torch.cat([o.stops for _, o in outs], dim=1)[:, :valid],
                       ref_stops[:, :valid])
    # a new generator of the same seed in each launch draws other masks
    other = _chunks(model, d, seq, proj, mask, [3, 5, 4], True, seed=3)
    assert not torch.equal(other[1][1].mel, outs[1][1].mel)


@pytest.mark.parametrize("min_iters,cut,valid", [(0, 1, 3), (9, 2, 2)])
def test_stop_fires_mid_chunk(taco, min_iters, cut, valid):
    """Every stop token on: it fires at iteration 6 (the first past step
    10), or at ``min_iters``. That launch runs ``valid`` iterations, pads the
    rest of its mel, reports done and carries out the state of the stop
    iteration (a plain loop of ``decoder_step`` to it); the launch after it
    runs none, pads all and hands its carry back."""
    jd, d, v, model, chars, spk = taco
    seq, proj = (torch.tensor(np.asarray(x)) for x in
                 jt.encode(v, jd, jnp.asarray(chars), jnp.asarray(spk))[:2])
    mask = torch.from_numpy((chars != 0).astype(np.float32))
    bias = model.decoder.stop_proj.bias.detach().clone()
    with torch.no_grad():
        model.decoder.stop_proj.bias.fill_(30.0)
    try:
        outs = _chunks(model, d, seq, proj, mask, [4] * 4, False, min_iters=min_iters)
        carry, prev = tt.init_decoder_carry(d, 2, 16), torch.zeros(2, d.n_mels)
        with torch.no_grad():
            for _ in range(4 * cut + valid):
                carry, m, _, _ = tt.decoder_step(model, d, 2, carry, prev, seq, proj, mask,
                                                 prenet_dropout=False)
                prev = m[:, :, -1]
    finally:
        with torch.no_grad():
            model.decoder.stop_proj.bias.copy_(bias)
    assert [int(o.valid) for _, o in outs] == [4] * cut + [valid] + [0] * (3 - cut)
    assert [int(o.done) for _, o in outs] == [0] * cut + [1] * (4 - cut)
    stopped = outs[cut][1]
    assert (stopped.mel[:, :, 2 * valid:] == PAD).all() and (stopped.mel[:, :, :2 * valid]
                                                             != PAD).all()
    assert (stopped.stops[:, valid:] == 0).all() and (stopped.stops[:, :valid] > 0.5).all()
    for a, b in zip((*stopped.carry, stopped.prev), (*carry, prev)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    for (c_in, p_in, _, _, _), after in outs[cut + 1:]:
        assert (after.mel == PAD).all()
        assert all(torch.equal(a, b) for a, b in zip((*after.carry, after.prev), (*c_in, p_in)))


@pytest.fixture(scope="module")
def synth_voc():
    syn = factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=2, override_hp=SYN,
                                   device="cpu")
    synth = tsyn.Synthesizer()
    synth.load_bundle(syn, r=2)
    voc = factories.init_voc_model(factories.MODEL_TYPE_RUNTIMERACER, seed=3, override_hp=VOC,
                                   device="cpu")
    embed = np.random.default_rng(5).uniform(0, 1, 768).astype(np.float32)
    return synth, voc, embed / np.linalg.norm(embed)


@pytest.mark.parametrize("valid", [12, 7])
def test_chunk_postnet_matches_jax(synth_voc, valid):
    """The postnet over [raw context | chunk], length-limited to the context
    and the chunk's valid frames (7 of 12: the final chunk's pad past the
    stop), against JAX ``_postnet`` on the same window; the raw context
    moves on to the window's last ``post_ctx`` frames."""
    synth, voc, _ = synth_voc
    model, d = synth._bundle.model, synth._bundle.dims
    jd = jt.TacotronDims(**d._asdict())
    v = jt.import_torch_state(model.state_dict(), jd)
    rng = np.random.default_rng(valid)
    post = tst._ChunkPost(model, voc, 8, 4, PAD, d.n_mels, "cpu", 100, 25)
    post.raw_hist = torch.from_numpy(rng.uniform(-4, 4, (d.n_mels, 8)).astype(np.float32))
    chunk = rng.uniform(-4, 4, (1, d.n_mels, 12)).astype(np.float32)
    win = np.concatenate([post.raw_hist.numpy(), chunk[0]], axis=1)
    with torch.no_grad():
        got = post.postnet(torch.from_numpy(chunk), valid).numpy()
    ref, _ = jt._postnet(v, jd, jnp.asarray(win[None]), False, None,
                         lengths=jnp.asarray([8 + valid]))
    np.testing.assert_allclose(got, np.swapaxes(np.asarray(ref), 1, 2)[0][:, 8:], atol=1e-5)
    assert np.array_equal(post.raw_hist.numpy(), win[:, -8:])


def _stub_window(cond):
    """A stand-in for the vocoder, a function of the window only: each
    frame's mean over the mels, hop samples a frame, and a frame past it."""
    return np.repeat(np.asarray(cond).mean(axis=0), HOP).tolist() + [0.0] * HOP


@pytest.mark.parametrize("T,chunk,first,ctx,xfade", [
    (2, 48, None, 12, 2), (11, 4, None, 3, 1), (40, 12, 4, 6, 2), (37, 16, None, 6, 2),
    (50, 8, 16, 1, 2), (9, 8, None, 12, 0)])
def test_stream_vocode_schedule_matches_jax(synth_voc, monkeypatch, T, chunk, first, ctx, xfade):
    """The chunks' lengths, indices, final flags and samples against JAX's
    ``stream_vocode`` over the same mel, both vocoders replaced by one
    function of the window (the schedule, trims and crossfades do not depend
    on the vocoder's draws); (T − 1)·hop samples in all."""
    _, voc, _ = synth_voc

    def jax_vocoder(*args, **kwargs):
        return lambda variables, cond, key: jnp.asarray(_stub_window(cond), jnp.float32)

    monkeypatch.setattr(jst, "_make_chunk_vocoder", jax_vocoder)
    monkeypatch.setattr(tst, "vocode_window", lambda voc, cond, *a: torch.tensor(
        _stub_window(cond), dtype=torch.float32))
    mel = np.random.default_rng(T).uniform(-4, 4, (80, T)).astype(np.float32)
    kw = dict(seed=3, chunk_frames=chunk, voc_ctx=ctx, xfade_frames=xfade,
              first_chunk_frames=first)
    want = list(jst.stream_vocode(None, jw.WaveRNNDims(**voc.dims._asdict()), mel,
                                  use_pallas=False, voc_config=voc.config, **kw))
    got = list(tst.stream_vocode(voc, mel, **kw))
    assert [(c.index, c.final, len(c.wav)) for c in got] == \
        [(c.index, c.final, len(c.wav)) for c in want]
    for a, b in zip(got, want):
        assert a.wav.dtype == np.float32
        np.testing.assert_allclose(a.wav, b.wav, atol=1e-6)
    assert sum(len(c.wav) for c in got) == (T - 1) * HOP
    assert sum(c.frames for c in got) == T


def test_stream_clone_decodes_the_batch_frames(synth_voc, monkeypatch):
    """The stream's raw decoder frames are the batch path's for the same
    seed (its encoder dropout, one generator through the decoder's
    launches), and as many."""
    synth, voc, embed = synth_voc
    decoded = []
    real = tst.tacotron_decode_chunk

    def spy(*args):
        decoded.append(real(*args))
        return decoded[-1]

    monkeypatch.setattr(tst, "tacotron_decode_chunk", spy)
    monkeypatch.setattr(tst, "vocode_window", lambda voc, cond, *a: torch.zeros(
        cond.shape[1] * HOP))
    chunks = list(tst.stream_clone(synth, voc, TEXT, embed, seed=4, chunk_frames=6))
    with torch.no_grad():
        seq, proj, mask = synth.encode(tsyn.text_ids([TEXT]), embed[None], 4)
        mel, _, stops = td.tacotron_decode_plain(synth._bundle.model, synth._bundle.dims, seq,
                                                 proj, mask, 4, 2, SYN.max_decoder_steps)
    n = 2 * tt.stop_iterations(stops, 2)
    assert sum(c.frames for c in chunks) == n
    streamed = torch.cat([o.mel[:, :, :2 * int(o.valid)] for o in decoded], dim=2)
    assert torch.equal(streamed, mel[:, :, :n])


@pytest.mark.parametrize("voc_ctx,xfade", [(12, 2), (0, 2), (1, 2), (0, 0)])
def test_stream_clone_length_invariant_and_context_clamp(synth_voc, monkeypatch, voc_ctx, xfade):
    """(Σ valid − 1)·hop samples for any requested context: voc_ctx is
    raised to 1 + xfade_frames (each window then starts that many frames
    before its chunk), and the stop held off to 40 frames."""
    synth, voc, embed = synth_voc
    widths = []
    real = tst.vocode_window

    def spy(voc, cond, *args):
        widths.append(cond.shape[1])
        return real(voc, cond, *args)

    monkeypatch.setattr(tst, "vocode_window", spy)
    chunks = list(tst.stream_clone(synth, voc, TEXT, embed, seed=1, chunk_frames=8, post_ctx=8,
                                   voc_ctx=voc_ctx, xfade_frames=xfade, voc_target=100,
                                   voc_overlap=25, min_frames=40))
    frames = [c.frames for c in chunks]
    ctx = max(voc_ctx, 1 + xfade)
    last = min(8, SYN.max_decoder_steps - 8 * (len(chunks) - 1))
    assert len(chunks) >= 5 and widths == [ctx + 8] * (len(chunks) - 1) + [ctx + last]
    assert [c.index for c in chunks] == list(range(len(chunks)))
    assert chunks[-1].final and not any(c.final for c in chunks[:-1])
    assert sum(len(c.wav) for c in chunks) == (sum(frames) - 1) * HOP
    assert sum(frames) >= 40
    assert all(np.isfinite(c.wav).all() and c.wav.dtype == np.float32 for c in chunks)


def test_stream_clone_ramps_its_first_chunk(synth_voc):
    """``first_chunk_frames`` cuts a smaller first chunk (its r-rounded
    iterations), the rest at ``chunk_frames``; the stream stays whole."""
    synth, voc, embed = synth_voc
    chunks = list(tst.stream_clone(synth, voc, TEXT, embed, seed=1, chunk_frames=12,
                                   first_chunk_frames=3, post_ctx=8, voc_ctx=4, voc_target=100,
                                   voc_overlap=25, min_frames=30))
    frames = [c.frames for c in chunks]
    assert frames[0] == 4 and all(f == 12 for f in frames[1:-1]) and len(frames) >= 3
    assert sum(len(c.wav) for c in chunks) == (sum(frames) - 1) * HOP


def test_stream_clone_stops_at_max_decoder_steps(synth_voc, monkeypatch):
    """With the stop held off, the stream decodes ``max_decoder_steps``
    frames, as the batch decode does: its last launch is cut short (30
    iterations in launches of 4: the last runs 2)."""
    synth, voc, embed = synth_voc
    launches = []
    real = tst.tacotron_decode_chunk

    def spy(*args):
        launches.append(args[11])
        return real(*args)

    monkeypatch.setattr(tst, "tacotron_decode_chunk", spy)
    monkeypatch.setattr(tst, "vocode_window", lambda voc, cond, *a: torch.zeros(
        cond.shape[1] * HOP))
    chunks = list(tst.stream_clone(synth, voc, TEXT, embed, chunk_frames=8,
                                   min_frames=SYN.max_decoder_steps))
    assert launches == [4] * 7 + [2]
    assert [c.frames for c in chunks] == [8] * 7 + [4] and chunks[-1].final
    assert sum(len(c.wav) for c in chunks) == (SYN.max_decoder_steps - 1) * HOP


def test_vocode_pipelined_order_and_single_calls(synth_voc):
    """Utterances come back in input order, each equal (greedy) to one
    ``wavernn_generate`` call on it, whatever the depth."""
    _, voc, _ = synth_voc
    rng = np.random.default_rng(2)
    mels = [rng.uniform(-1, 0, (80, n)).astype(np.float32) for n in (5, 9, 2, 3)]
    want = [tw.wavernn_generate(voc.model, voc.dims, m, 0, target=100, overlap=25, argmax=True)
            for m in mels]
    for depth in (1, 3, 8):
        got = list(pipelined.vocode_pipelined(voc, iter(mels), seed=4, depth=depth, target=100,
                                              overlap=25, argmax=True))
        assert len(got) == len(mels)
        for g, w, m in zip(got, want, mels):
            assert g.dtype == np.float64 and g.shape == ((m.shape[1] - 1) * HOP,)
            assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="at least 2 frames"):
        list(pipelined.vocode_pipelined(voc, [mels[0][:, :1]], argmax=True))


def _nar_stream_equals_stream_vocode(synth_voc, model_type, narrow):
    _, voc, embed = synth_voc
    cfg = factories.default_config(model_type).replace(**narrow)
    nar = tsyn.Synthesizer()
    nar.load_bundle(factories.init_syn_model(model_type, seed=4, override_hp=cfg, device="cpu"))
    kw = dict(chunk_frames=24, first_chunk_frames=8, voc_target=100, voc_overlap=25)
    got = list(tst.stream_clone(nar, voc, TEXT, embed, seed=6, **kw))
    [mel] = nar.synthesize_spectrograms([TEXT], [embed], seed=6)
    want = list(tst.stream_vocode(voc, mel, 6, **kw))
    assert len(got) == len(want) >= 2 and sum(c.frames for c in got) == mel.shape[1]
    for a, b in zip(got, want):
        assert (a.index, a.final, a.frames) == (b.index, b.final, b.frames)
        assert np.array_equal(a.wav, b.wav)
    assert sum(len(c.wav) for c in got) == (mel.shape[1] - 1) * HOP


def test_nar_stream_raises(synth_voc):
    """A ForwardTacotron streams (it no longer raises): its stream is the
    batch mel of the same seed through ``stream_vocode``, chunk for chunk
    and sample for sample, as in the JAX package."""
    _nar_stream_equals_stream_vocode(synth_voc, factories.MODEL_TYPE_FORWARD_TACOTRON, FT_CFG)


def test_nar_stream_of_fast_pitch(synth_voc):
    """FastPitch streams the same way."""
    _nar_stream_equals_stream_vocode(synth_voc, factories.MODEL_TYPE_FASTPITCH, FP_CFG)
