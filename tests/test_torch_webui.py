"""The browser toolbox (``rtvc_tpu_torch/webui.py`` mounted by
``serve.create_server``) through real requests against a server on a free
loopback port, with the narrow models of ``test_torch_toolbox.py`` on the
CPU: ``GET /`` is the JAX page byte for byte; ``/api/samples`` lists what the
JAX ``UIState`` lists; ``/api/load`` (a sample mp3, a WAV body) embeds as the
module functions do, and within 1e-5 of the JAX encoder on the same weights;
``/api/synthesize``, ``/api/autotune`` and ``/api/stream`` give the bytes the
module functions give after the same seeds (each route moves the vocoder's
seed counter as the JAX route does), with the JAX routes' headers and
status codes; ``/api/mel``'s JSON equals the JAX route's on the same mel and
``/api/projection``'s points are within 1e-5 of the JAX route's on the same
embeddings; every model section runs on the server's model thread; under
the native engine ``/api/stream`` and ``/stream`` answer 400 and
``/api/synthesize`` vocodes there."""
import http.client
import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from rtvc_tpu import serve as jserve
from rtvc_tpu import webui as jwebui
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu_torch import serve as tserve
from rtvc_tpu_torch import toolbox as ttb
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.inference import streaming as tst
from rtvc_tpu_torch.inference import vocoder as tvoc
from test_torch_toolbox import _one_cpu_thread, _voice, models  # noqa: F401  (fixtures)

REPO = Path(__file__).resolve().parents[1]
TEXT = "Browse this voice."
QTEXT = TEXT.replace(" ", "%20")
STREAM_KW = {"voc_target": 100, "voc_overlap": 25}


@pytest.fixture
def server(models, tmp_path):
    """A server with the UI over a samples directory of one mp3 and one
    wav; the file's models reinstalled first."""
    synth, voc = models
    tvoc.load_bundle(voc)
    samples = tmp_path / "samples"
    (samples / "sub").mkdir(parents=True)
    shutil.copy(REPO / "samples" / "p240_00000.mp3", samples / "p240_00000.mp3")
    _voice(samples / "sub" / "tone.wav", 170.0)
    (samples / "README.md").write_text("not audio")
    srv = tserve.create_server("127.0.0.1", 0, synth=synth, stream_kwargs=STREAM_KW,
                               samples_dir=samples)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(10)
    assert not thread.is_alive()


def _request(srv, method, path, body=None):
    """(status, headers, body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _wav_body(f0=220.0, seed=0):
    t = np.arange(16000) / 16000
    rng = np.random.default_rng(seed)
    wav = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.003 * rng.standard_normal(t.size)
    return tserve._wav_bytes(wav.astype(np.float32), 16000)


def _load(srv, name, f0, seed=0):
    status, _, body = _request(srv, "POST", f"/api/load?name={name}", _wav_body(f0, seed))
    assert status == 200, body
    return json.loads(body)


class _JaxHandler:
    """What the JAX package's ``handle_get`` writes through ``_json``."""

    def __init__(self, path):
        self.path = path
        self.out = None

    def _json(self, obj, code=200):
        self.out = (json.loads(json.dumps(obj)), code)


def test_page_and_samples_are_the_jax_routes(server):
    for path in ("/", "/index.html"):
        status, headers, body = _request(server, "GET", path)
        assert status == 200 and headers["Content-Type"] == "text/html; charset=utf-8"
        assert body == jwebui.PAGE.encode() and headers["Content-Length"] == str(len(body))
    status, headers, body = _request(server, "GET", "/api/samples")
    root = server.ui_state.samples_dir
    want = [str(p.relative_to(root)) for p in jwebui.UIState(root).sample_files()]
    assert status == 200 and headers["Content-Type"] == "application/json"
    assert json.loads(body) == {"samples": want, "loaded": []}
    assert want == ["p240_00000.mp3", "sub/tone.wav"]
    assert _request(server, "GET", "/api/nothing")[0] == 404
    assert _request(server, "GET", "/health")[0] == 200


def test_load_embeds_a_sample_and_a_wav_body(server):
    status, _, body = _request(server, "POST", "/api/load?sample=p240_00000.mp3")
    assert status == 200, body
    got = json.loads(body)
    wav = tenc.preprocess_wav(server.ui_state.samples_dir / "p240_00000.mp3")
    assert got["name"] == "p240_00000" and got["seconds"] == round(len(wav) / 16000, 2)
    embed = np.asarray(got["embed"])
    assert embed.shape == (768,) and np.array_equal(embed, tenc.embed_utterance(wav))
    np.testing.assert_allclose(embed, jenc.embed_utterance(wav), atol=1e-5)

    body = _wav_body(230.0)
    got = _load(server, "tone", 230.0)
    raw, sr = jserve._parse_wav(body)
    want = jenc.embed_utterance(jenc.preprocess_wav(raw, source_sr=sr))
    assert got["name"] == "tone" and got["seconds"] == round(len(jenc.preprocess_wav(
        raw, source_sr=sr)) / 16000, 2)
    np.testing.assert_allclose(np.asarray(got["embed"]), want, atol=1e-5)
    status, _, body = _request(server, "GET", "/api/samples")
    assert json.loads(body)["loaded"] == ["p240_00000", "tone"]


def test_load_errors(server):
    status, _, body = _request(server, "POST", "/api/load?sample=../../x.wav")
    assert status == 404 and json.loads(body) == {"error": "no sample '../../x.wav'"}
    status, _, body = _request(server, "POST", "/api/load")
    assert status == 400 and json.loads(body) == {"error": "need ?sample= or a WAV body"}
    silence = tserve._wav_bytes(np.zeros(16000, np.float32), 16000)
    status, _, body = _request(server, "POST", "/api/load?name=quiet", silence)
    assert status == 400 and json.loads(body) == {"error": "no speech after VAD trim"}
    status, _, body = _request(server, "POST", "/api/load?name=x", b"not a wav")
    assert status == 500 and "error" in json.loads(body)


def test_synthesize_is_seeded_with_the_jax_headers(server, models):
    """Two requests at seed 3 give the same bytes, those of the module
    functions after ``set_seed(3)``; the counter stands where one
    ``set_seed`` and one vocode leave it; ``/api/mel`` is then the JAX
    route's JSON of that mel."""
    synth, _ = models
    status, _, body = _request(server, "GET", "/api/mel")
    assert status == 404 and json.loads(body) == {"error": "nothing synthesized yet"}
    embed = np.asarray(_load(server, "tone", 210.0)["embed"], np.float32)
    path = f"/api/synthesize?utt=tone&seed=3&text={QTEXT}"
    answers = [_request(server, "POST", path) for _ in range(2)]
    assert (tvoc._seed, tvoc._gen_counter) == (3, 1)
    [mel] = synth.synthesize_spectrograms([TEXT], [server.ui_state.utterances["tone"]["embed"]],
                                          seed=3)
    tvoc.set_seed(3)
    want = tserve._wav_bytes(tvoc.infer_waveform(mel), 16000)
    for status, headers, body in answers:
        assert status == 200 and headers["Content-Type"] == "audio/wav" and body == want
        assert float(headers["X-RTF"]) > 0 and headers["X-Mel-Frames"] == str(mel.shape[1])
    np.testing.assert_array_equal(server.ui_state.last_mel, mel)
    np.testing.assert_allclose(server.ui_state.utterances["tone"]["embed"], embed, atol=1e-7)

    handler = _JaxHandler("/api/mel")
    state = jwebui.UIState(server.ui_state.samples_dir)
    for m in (mel, np.random.default_rng(6).uniform(-4, 4, (80, 1100)).astype(np.float32)):
        server.ui_state.last_mel = state.last_mel = m
        status, _, body = _request(server, "GET", "/api/mel")
        assert jwebui.handle_get(handler, state)
        assert (json.loads(body), status) == handler.out
    assert handler.out[0]["frames"] == 550 and handler.out[0]["n_mels"] == 80

    for bad in (f"/api/synthesize?utt=nobody&text={QTEXT}", "/api/synthesize?utt=tone"):
        status, _, body = _request(server, "POST", bad, b"drained")
        assert status == 400 and json.loads(body) == {"error": "need ?text= and a loaded ?utt="}


def test_projection_points_match_the_jax_route(server):
    status, _, body = _request(server, "GET", "/api/projection")
    assert status == 200 and json.loads(body) == {"points": [],
                                                  "note": "load 2+ utterances to project"}
    for i, f0 in enumerate((150.0, 260.0, 380.0)):
        _load(server, f"v{i}", f0, seed=i)
    status, _, body = _request(server, "GET", "/api/projection")
    got = json.loads(body)["points"]
    state = jwebui.UIState(server.ui_state.samples_dir)
    state.utterances = dict(server.ui_state.utterances)
    handler = _JaxHandler("/api/projection")
    assert status == 200 and jwebui.handle_get(handler, state)
    want = handler.out[0]["points"]
    assert [p["name"] for p in got] == [p["name"] for p in want] == ["v0", "v1", "v2"]
    np.testing.assert_allclose([[p["x"], p["y"]] for p in got],
                               [[p["x"], p["y"]] for p in want], atol=1e-5)


def test_autotune_answers_the_best_seed(server, models, monkeypatch):
    """Two seeds from 1: the best seed's wav and headers, the bytes of
    ``autotune_search`` in process; ``n_seeds`` is clamped to [1, 50]; no
    voiced audio answers 500."""
    synth, _ = models
    _load(server, "tone", 190.0)
    status, headers, body = _request(
        server, "POST", f"/api/autotune?utt=tone&n_seeds=2&start_seed=1&text={QTEXT}")
    assert (tvoc._seed, tvoc._gen_counter) == (2, 1)
    seed, sim, wav, mel = ttb.autotune_search(synth, server.ui_state.utterances["tone"]["embed"],
                                              TEXT, n_seeds=2, start_seed=1, verbose=False)
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert headers["X-Best-Seed"] == str(seed) and headers["X-Similarity"] == f"{sim:.4f}"
    assert body == tserve._wav_bytes(wav, 16000)
    np.testing.assert_array_equal(server.ui_state.last_mel, mel)

    asked = []

    def fake(synth, embed, text, n_seeds, start_seed, verbose):
        asked.append((n_seeds, start_seed, verbose))
        return -1, -np.inf, None, None

    monkeypatch.setattr(ttb, "autotune_search", fake)
    for n in ("99", "0"):
        status, _, body = _request(
            server, "POST", f"/api/autotune?utt=tone&n_seeds={n}&start_seed=7&text={QTEXT}")
        assert status == 500 and json.loads(body) == {"error": "autotune produced no voiced "
                                                               "audio"}
    assert asked == [(50, 7, False), (1, 7, False)]
    status, _, body = _request(server, "POST", "/api/autotune?utt=none&text=hi")
    assert status == 400


def test_stream_route_streams_the_loaded_voice(server, models):
    """``GET /api/stream`` answers the chunked streaming WAV of
    ``stream_clone`` on the stored embedding, at the stream's own seed: the
    same bytes twice, and the vocoder's seed counter unmoved."""
    synth, _ = models
    _load(server, "tone", 200.0)
    tvoc.set_seed(5)
    answers = [_request(server, "GET", f"/api/stream?utt=tone&text={QTEXT}") for _ in range(2)]
    assert (tvoc._seed, tvoc._gen_counter) == (5, 0)
    chunks = list(tst.stream_clone(synth, None, TEXT, server.ui_state.utterances["tone"]["embed"],
                                   **STREAM_KW))
    want = tserve._streaming_wav_header(16000) + b"".join(tserve._pcm16(c.wav) for c in chunks)
    for status, headers, body in answers:
        assert status == 200 and headers["Transfer-Encoding"] == "chunked" and body == want
    assert len(want) - 44 == 2 * (sum(c.frames for c in chunks) - 1) * 200
    status, _, body = _request(server, "GET", f"/api/stream?utt=nobody&text={QTEXT}")
    assert status == 400 and json.loads(body) == {"error": "need ?text= and a loaded ?utt="}


def test_model_work_runs_on_the_model_thread(server, monkeypatch):
    """The embedding of /api/load, the synthesis and vocode of
    /api/synthesize and the seed search of /api/autotune each run on the
    server's one model thread."""
    seen = []

    def spy(fn):
        def run(*args, **kwargs):
            seen.append((fn.__name__, threading.get_ident()))
            return fn(*args, **kwargs)
        return run

    for mod, name in ((tenc, "embed_utterance"), (tvoc, "infer_waveform"),
                      (server.synth, "synthesize_spectrograms")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    _load(server, "tone", 240.0)
    assert _request(server, "POST", f"/api/synthesize?utt=tone&seed=1&text={QTEXT}")[0] == 200
    assert _request(server, "POST", f"/api/autotune?utt=tone&n_seeds=1&text={QTEXT}")[0] == 200
    names = [n for n, _ in seen]
    assert names.count("embed_utterance") == 2 and names.count("infer_waveform") == 2
    assert names.count("synthesize_spectrograms") == 2
    model_thread = server.on_models(threading.get_ident)
    assert {t for _, t in seen} == {model_thread} != {threading.get_ident()}


def test_native_engine_refuses_streams_and_vocodes_synthesis(server, models, tmp_path):
    from rtvc_tpu_torch.native.convert import export_wavernn

    synth, voc = models
    export_wavernn(voc.model, voc.dims, tmp_path / "voc.bin")
    tvoc.load_model(tmp_path / "voc.bin", voc_type="libwavernn", verbose=False)
    try:
        _load(server, "tone", 210.0)
        status, _, body = _request(server, "GET", f"/api/stream?utt=tone&text={QTEXT}")
        assert status == 400 and "native engine" in json.loads(body)["error"]
        status, _, body = _request(server, "POST", f"/stream?text={QTEXT}", _wav_body())
        assert status == 400 and "native engine" in json.loads(body)["error"]
        status, headers, body = _request(server, "POST",
                                         f"/api/synthesize?utt=tone&seed=2&text={QTEXT}")
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        [mel] = synth.synthesize_spectrograms(
            [TEXT], [server.ui_state.utterances["tone"]["embed"]], seed=2)
        tvoc.set_seed(2)
        assert body == tserve._wav_bytes(tvoc.infer_waveform(mel), 16000)
        status, _, body = _request(server, "GET", "/health")
        assert json.loads(body) == {"status": "ok", "platform": "cpu", "device": "cpu",
                                    "synthesizer": True, "vocoder": True}
    finally:
        tvoc.load_bundle(voc)


def test_server_without_the_ui(models):
    srv = tserve.create_server("127.0.0.1", 0, synth=models[0], ui=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert srv.ui_state is None
        assert _request(srv, "GET", "/")[0] == 404
        assert _request(srv, "GET", "/api/samples")[0] == 404
        assert _request(srv, "POST", "/api/load?name=x", _wav_body())[0] == 404
        assert _request(srv, "GET", "/health")[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)
