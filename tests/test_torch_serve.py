"""The port's entry points at the narrow widths of ``test_torch_clone.py``:
``rtvc_tpu_torch.serve`` over models loaded from checkpoints, on the CPU
(``/health``, ``/embed``, ``/clone`` and ``/stream`` answer what the module
functions give under the same seed, byte for byte, with a Tacotron and with
each NAR synthesizer; its wav codec and its
streaming header are the JAX package's), and ``python -m
rtvc_tpu_torch.demo_cli --selftest [--stream] --cpu``."""
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from rtvc_tpu import serve as jserve
from rtvc_tpu_torch import serve as tserve
from rtvc_tpu_torch.config.encoder import EncoderDataParams
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.inference import streaming as tst
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.train.checkpoints import save_checkpoint
from test_torch_clone import ENC, SYN, VOC, _prompt
from test_torch_fast_pitch import CFG as FP_CFG
from test_torch_forward_tacotron import CFG as FT_CFG

REPO = Path(__file__).resolve().parents[1]
TEXT = "Serve this voice."
# a short fold window keeps the sample loop's steps few on the CPU
VOC_SERVE = VOC.replace(gen_target=100, gen_overlap=25)
STREAM_KW = {"voc_target": 100, "voc_overlap": 25}


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread: these CPU models are small, and beside the other
    test workers more OpenMP threads only wait on each other (a 6 s test
    took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_wav_codec_matches_the_jax_server():
    rng = np.random.default_rng(0)
    wav = np.concatenate([rng.uniform(-1.2, 1.2, 999), [1.0, -1.0, 0.0]])
    body = tserve._wav_bytes(wav, 16000)
    assert body == jserve._wav_bytes(wav, 16000)
    x, sr = tserve._parse_wav(body)
    assert sr == 16000 and x.dtype == np.float32 and x.shape == wav.shape
    # written at a scale of 32767, read at 32768: two steps of 16 bits
    np.testing.assert_allclose(x, np.clip(wav, -1, 1), atol=2.0 / 32767)
    jx, jsr = jserve._parse_wav(body)
    assert jsr == sr and np.array_equal(x, jx)
    stereo = np.repeat(np.frombuffer(body[44:], "<i2")[:, None], 2, axis=1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(stereo.tobytes())
    x2, sr2 = tserve._parse_wav(buf.getvalue())
    assert sr2 == 22050 and np.array_equal(x2, x)


@pytest.fixture
def server(tmp_path, monkeypatch):
    """Narrow models written as the port's trainer files, loaded through the
    inference modules' ``load_model``, served on a free loopback port."""
    for mod, names in ((tenc, ("_model", "_model_cfg", "_data")), (tsyn, ("_model",)),
                       (tvoc, ("_bundle", "_seed", "_gen_counter"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    enc = factories.init_encoder_model(1, "cpu", ENC)
    save_checkpoint(tmp_path / "enc.pt", enc, 3, "speaker_encoder",
                    extras={"config": {"model": ENC.asdict(),
                                       "data": EncoderDataParams().asdict()}})
    syn = factories.init_syn_model("tacotron", seed=2, override_hp=SYN, device="cpu")
    save_checkpoint(tmp_path / "syn.pt", syn.model, 4, "tacotron",
                    extras={"r": 2, "config": SYN.asdict()})
    voc = factories.init_voc_model("runtimeracer-wavernn", seed=3, override_hp=VOC_SERVE,
                                   device="cpu")
    save_checkpoint(tmp_path / "voc.pt", voc.model, 5, "runtimeracer-wavernn",
                    extras={"config": VOC_SERVE.asdict()})
    tenc.load_model(tmp_path / "enc.pt", device="cpu")
    tsyn.load_model(tmp_path / "syn.pt", verbose=False, device="cpu")
    tvoc.load_model(tmp_path / "voc.pt", verbose=False, device="cpu")
    assert tenc._model_cfg == ENC and tsyn._model._bundle.config == SYN
    assert tvoc._bundle.config == VOC_SERVE
    assert tvoc.warmup() == 1

    srv = tserve.create_server("127.0.0.1", 0, synth=tsyn._model, stream_kwargs=STREAM_KW)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(10)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _in_process_clone(body, text):
    wav, sr = tserve._parse_wav(body)
    embed = tenc.embed_utterance(tenc.preprocess_wav(wav, source_sr=sr))
    [mel] = tsyn.synthesize_spectrograms([text], [embed])
    return embed, mel, tvoc.infer_waveform(mel)


def test_server_answers_as_the_module_functions(server):
    port = server.server_address[1]
    status, ctype, body = _request(port, "GET", "/health")
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == {"status": "ok", "platform": "cpu", "device": "cpu",
                                "synthesizer": True, "vocoder": True}

    prompt = tserve._wav_bytes(_prompt(1), 16000)
    status, _, body = _request(port, "POST", "/embed", prompt)
    assert status == 200
    embed = np.asarray(json.loads(body)["embed"])
    want, _, _ = _in_process_clone(prompt, TEXT)
    assert embed.shape == (768,) and np.array_equal(embed, want.astype(np.float64))

    tvoc.set_seed(7)
    clones = [_request(port, "POST", "/clone?text=Serve%20this%20voice.", prompt)
              for _ in range(2)]
    tvoc.set_seed(7)
    for status, ctype, body in clones:
        assert status == 200 and ctype == "audio/wav"
        _, mel, wav = _in_process_clone(prompt, TEXT)
        assert body == tserve._wav_bytes(wav, 16000)
        assert tserve._parse_wav(body)[0].shape == ((mel.shape[1] - 1) * 200,)
    # each request takes the next seed of the counter
    assert clones[0][2] != clones[1][2]


def test_server_errors(server):
    port = server.server_address[1]
    status, ctype, body = _request(port, "POST", "/clone", b"")
    assert status == 400 and json.loads(body) == {"error": "missing ?text="}
    status, _, body = _request(port, "POST", "/clone?text=hi", b"not a wav")
    assert status == 500 and "error" in json.loads(body)
    status, ctype, body = _request(port, "POST", "/stream?text=hi", b"")
    assert status == 500 and ctype == "application/json" and "error" in json.loads(body)
    # the browser toolbox is mounted by default: its page, and its stream
    # route refuses a request without a loaded utterance
    assert _request(port, "GET", "/")[:2] == (200, "text/html; charset=utf-8")
    status, ctype, body = _request(port, "GET", "/api/stream?text=hi")
    assert status == 400 and json.loads(body) == {"error": "need ?text= and a loaded ?utt="}
    assert _request(port, "GET", "/nothing")[0] == 404
    # the server keeps serving after an error
    assert _request(port, "GET", "/health")[0] == 200


def test_server_runs_the_models_on_one_thread(server, monkeypatch):
    """Concurrent clones take their turns on the one model thread, each with
    the next seed of the counter; ``warm_clone`` runs there too and leaves
    the counter where it was."""
    threads = []
    infer = tvoc.infer_waveform

    def spy(*args, **kwargs):
        threads.append(threading.get_ident())
        return infer(*args, **kwargs)

    monkeypatch.setattr(tvoc, "infer_waveform", spy)
    port = server.server_address[1]
    prompt = tserve._wav_bytes(_prompt(2), 16000)
    tvoc.set_seed(11)
    server.warm_clone()
    assert (tvoc._seed, tvoc._gen_counter) == (11, 0)
    answers = [None, None]

    def clone(i):
        answers[i] = _request(port, "POST", "/clone?text=Serve%20this%20voice.", prompt)

    clients = [threading.Thread(target=clone, args=(i,)) for i in range(2)]
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    assert len(set(threads)) == 1 and threads[0] != threading.get_ident()
    tvoc.set_seed(11)
    want = {tserve._wav_bytes(_in_process_clone(prompt, TEXT)[2], 16000) for _ in range(2)}
    assert [a[0] for a in answers] == [200, 200] and {a[2] for a in answers} == want
    assert len(want) == 2


def _stream(port, text, body):
    """(status, headers, body) of a POST /stream; raises on a truncated
    chunked body."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/stream?text=" + text.replace(" ", "%20"), body=body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_stream_answers_a_chunked_streaming_wav(server):
    """/stream answers 200 with chunked transfer: the JAX server's streaming
    header, then the PCM of ``stream_clone``'s chunks, equal byte for byte
    to the stream replayed in process after ``set_seed`` (each stream takes
    the vocoder's next seed, as a /clone does): (Σ frames − 1)·hop
    samples."""
    port = server.server_address[1]
    prompt = tserve._wav_bytes(_prompt(3), 16000)
    tvoc.set_seed(5)
    answers = [_stream(port, TEXT, prompt) for _ in range(2)]
    tvoc.set_seed(5)
    wav, sr = tserve._parse_wav(prompt)
    embed = tenc.embed_utterance(tenc.preprocess_wav(wav, source_sr=sr))
    for status, headers, body in answers:
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        assert headers["Transfer-Encoding"] == "chunked" and "Content-Length" not in headers
        assert body[:44] == tserve._streaming_wav_header(16000) == jserve._streaming_wav_header(
            16000)
        chunks = list(tst.stream_clone(tsyn._model, None, TEXT, embed,
                                       voc_seed=tvoc.next_seed(), **STREAM_KW))
        assert body[44:] == b"".join(tserve._pcm16(c.wav) for c in chunks)
        assert len(body) - 44 == 2 * (sum(c.frames for c in chunks) - 1) * 200
    assert answers[0][2] != answers[1][2]


@pytest.mark.parametrize("model_type,narrow", [("forward-tacotron", FT_CFG),
                                               ("fast-pitch", FP_CFG)])
def test_nar_synthesizer_serves_clone_and_stream(server, tmp_path, model_type, narrow):
    """A ForwardTacotron or FastPitch loaded through ``synthesizer.load_model``
    (the type read from the checkpoint) serves /clone and /stream after
    ``warm_clone``, unchanged: the bytes equal the module functions' and
    ``stream_clone``'s in process under the same seeds."""
    cfg = factories.default_config(model_type).replace(**narrow)
    syn = factories.init_syn_model(model_type, seed=6, override_hp=cfg, device="cpu")
    save_checkpoint(tmp_path / "nar.pt", syn.model, 8, model_type,
                    extras={"config": cfg.asdict()})
    tsyn.load_model(tmp_path / "nar.pt", verbose=False, device="cpu")
    assert tsyn.get_model_type() == model_type
    srv = tserve.create_server("127.0.0.1", 0, synth=tsyn._model, stream_kwargs=STREAM_KW)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    prompt = tserve._wav_bytes(_prompt(2), 16000)
    try:
        srv.warm_clone()
        port = srv.server_address[1]
        tvoc.set_seed(9)
        status, ctype, body = _request(port, "POST", "/clone?text=Serve%20this%20voice.", prompt)
        streamed = _stream(port, TEXT, prompt)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)
    tvoc.set_seed(9)
    embed, mel, wav = _in_process_clone(prompt, TEXT)
    assert status == 200 and ctype == "audio/wav" and body == tserve._wav_bytes(wav, 16000)
    assert tserve._parse_wav(body)[0].shape == ((mel.shape[1] - 1) * 200,)
    status, headers, data = streamed
    chunks = list(tst.stream_clone(tsyn._model, None, TEXT, embed, voc_seed=tvoc.next_seed(),
                                   **STREAM_KW))
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert sum(c.frames for c in chunks) == mel.shape[1]
    assert data[44:] == b"".join(tserve._pcm16(c.wav) for c in chunks)
    assert len(data) - 44 == 2 * (mel.shape[1] - 1) * 200


def test_stream_errors(server, monkeypatch):
    """An error before the header (no text, a body that is not a wav, a
    first chunk that fails) comes back as JSON; one after it ends the
    response short of its last chunk. The server keeps serving."""
    port = server.server_address[1]
    prompt = tserve._wav_bytes(_prompt(3), 16000)
    status, _, body = _request(port, "POST", "/stream", prompt)
    assert status == 400 and json.loads(body) == {"error": "missing ?text="}
    status, _, body = _request(port, "POST", "/stream?text=hi", b"not a wav")
    assert status == 500 and "error" in json.loads(body)

    def first_fails(*args, **kwargs):
        raise RuntimeError("no first chunk")
        yield

    def later_fails(*args, **kwargs):
        yield tst.StreamChunk(np.full(50, 0.25, np.float32), 0, False, 0.0, 1)
        raise RuntimeError("no second chunk")

    monkeypatch.setattr(tst, "stream_clone", first_fails)
    status, headers, body = _stream(port, "hi", prompt)
    assert status == 500 and json.loads(body) == {"error": "RuntimeError('no first chunk')"}
    monkeypatch.setattr(tst, "stream_clone", later_fails)
    with pytest.raises(http.client.IncompleteRead) as got:
        _stream(port, "hi", prompt)
    assert got.value.partial == tserve._streaming_wav_header(16000) + tserve._pcm16(
        np.full(50, 0.25))
    assert _request(port, "GET", "/health")[0] == 200


def test_stream_steps_on_the_model_thread(server, monkeypatch):
    """Every step of the stream's generator (its creation, each ``next``
    and the one that ends it) runs on the model thread; the chunks go out
    in order."""
    seen = []

    def fake(synth, voc, text, embed, **kwargs):
        for i in range(3):
            seen.append(threading.get_ident())
            yield tst.StreamChunk(np.full(20, 0.1 * i, np.float32), i, i == 2, 0.0, 1)
        seen.append(threading.get_ident())

    monkeypatch.setattr(tst, "stream_clone", fake)
    model_thread = server.on_models(threading.get_ident)
    status, _, body = _stream(server.server_address[1], "hi", tserve._wav_bytes(_prompt(), 16000))
    assert status == 200 and len(seen) == 4 and set(seen) == {model_thread}
    assert model_thread != threading.get_ident()
    assert body[44:] == b"".join(tserve._pcm16(np.full(20, 0.1 * i, np.float32))
                                 for i in range(3))


def test_serve_main_stops_without_its_checkpoints(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["-e", str(tmp_path / "e.pt"), "-s", str(tmp_path / "s.pt"),
                     "-v", str(tmp_path / "v.pt"), "--cpu"])
    assert exc.value.code == -1
    assert "python -m rtvc_tpu_torch.vocoder_train" in capsys.readouterr().out


def _demo_cli(cwd, *args):
    # one OpenMP thread: the self-test's small products gain nothing from
    # more, and beside other test workers more threads only wait on each other
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "rtvc_tpu_torch.demo_cli", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_demo_cli_selftest_runs_on_random_weights(tmp_path):
    proc = _demo_cli(tmp_path, "--selftest", "--cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "RANDOM weights" in proc.stdout and "All test passed" in proc.stdout
    assert "jax" not in proc.stderr


def test_demo_cli_selftest_streams(tmp_path):
    proc = _demo_cli(tmp_path, "--selftest", "--stream", "--cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "Testing the stream" in proc.stdout and "All test passed" in proc.stdout


def test_demo_cli_refuses_a_partial_install(tmp_path):
    (tmp_path / "enc.pt").write_bytes(b"")
    proc = _demo_cli(tmp_path, "--selftest", "--cpu", "-e", "enc.pt")
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "synthesizer, vocoder" in proc.stdout
