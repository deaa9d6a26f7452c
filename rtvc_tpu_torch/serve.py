"""HTTP front end of the clone pipeline (counterpart of ``rtvc_tpu/serve.py``).

Stdlib ``http.server`` over the port's inference modules:

  * ``GET  /health``          → {"status": "ok", "platform", "device",
    "synthesizer", "vocoder"}
  * ``POST /embed``           body = WAV bytes → {"embed": [768 floats]}
  * ``POST /clone?text=...``  body = WAV prompt → WAV clone
  * ``POST /stream?text=...`` body = WAV prompt → the clone as a streaming
    WAV (chunked transfer: a header of the largest data length, then PCM
    chunk by chunk as ``inference.streaming.stream_clone`` yields them)

With ``ui=True`` (the default) the server also mounts the browser toolbox
(``webui.py``): ``GET /`` (the page), ``GET /api/samples``, ``/api/mel``,
``/api/projection`` and ``/api/stream``, and ``POST /api/load``,
``/api/synthesize`` and ``/api/autotune``; ``--samples_dir`` names the
audio directory its page lists (the repository's ``samples/`` by
default), ``--no_ui`` serves the API alone.

Start: ``python -m rtvc_tpu_torch.serve -e enc.ckpt -s syn.pt -v voc.pt``
(any of the checkpoint formats ``train/checkpoints.py:read_model`` reads,
a synthesizer of any of the three types;
the models run on the card, or on the CPU with ``--cpu``), or build a
server over models already installed with ``create_server(...)``. Binds
loopback by default. Every request's model work runs on one long-lived
thread, in the order the requests come (a stream's: each step of its
generator); sockets are read and written on the handler threads, so a slow
reader of a stream never holds the model thread.
"""
from __future__ import annotations

import io
import json
import struct
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(_pcm16(wav))
    return buf.getvalue()


def _pcm16(wav: np.ndarray) -> bytes:
    x = np.clip(np.asarray(wav, np.float64), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


def _parse_wav(body: bytes) -> tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(body), "rb") as w:
        sr = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def _streaming_wav_header(sr: int) -> bytes:
    """A WAV header with the largest data length: a stream of unknown length
    (players read until the connection closes)."""
    data_len = 0x7FFFF000
    return (b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", data_len))


def stream_chunked_wav(handler, gen, on_models, sr: int) -> None:
    """Answer with a chunked-transfer WAV from a generator of stream chunks.
    Each ``next(gen)`` runs through ``on_models`` (the model thread); the
    writes to the client run here. The first chunk is made before the
    status line, so an error up to it still comes back as JSON (raised to
    the caller); a failure after the header drops the connection, since a
    second status line would corrupt the chunked framing: the client sees
    a truncated stream."""
    def chunk_out(data: bytes):
        handler.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

    piece = on_models(next, gen, None)
    try:
        handler.send_response(200)
        handler.send_header("Content-Type", "audio/wav")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        chunk_out(_streaming_wav_header(sr))
        while piece is not None:
            if len(piece.wav):
                chunk_out(_pcm16(piece.wav))
            piece = on_models(next, gen, None)
        handler.wfile.write(b"0\r\n\r\n")
    except BrokenPipeError:
        pass
    except Exception:
        handler.close_connection = True
    finally:
        on_models(gen.close)


def voiced_prompt(seed: int = 0, seconds: float = 3.0, sr: int = 16000) -> np.ndarray:
    """A voiced-sounding test prompt: harmonics under a syllable envelope."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110 + 40 * seed + 15 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, 6)), 0, None) ** 0.5
    return (0.2 * voice * env + 0.003 * rng.standard_normal(t.size)).astype(np.float32)


def _models_device():
    """The device of the installed models (the vocoder's, else the
    encoder's: the native engine runs on the host), or None before any is
    installed."""
    from rtvc_tpu_torch.inference import encoder, vocoder

    if vocoder._bundle is not None:
        return vocoder._bundle.model.I.weight.device
    return encoder._device() if encoder.is_loaded() else None


def _embed(wav: np.ndarray, sr: int) -> np.ndarray:
    from rtvc_tpu_torch.inference import encoder

    return encoder.embed_utterance(encoder.preprocess_wav(wav, source_sr=sr))


def _clone(synth, wav: np.ndarray, sr: int, text: str) -> np.ndarray:
    from rtvc_tpu_torch.inference import vocoder

    [mel] = synth.synthesize_spectrograms([text], [_embed(wav, sr)])
    return vocoder.infer_waveform(mel)


def _warm_stream(synth, wav: np.ndarray, sr: int, text: str, stream_kwargs: dict) -> None:
    gen = _open_stream(synth, wav, sr, text, stream_kwargs)
    for _ in range(2):
        next(gen, None)
    gen.close()


def _open_stream(synth, wav: np.ndarray, sr: int, text: str, stream_kwargs: dict):
    """The prompt's embedding, then a ``stream_clone`` generator whose
    chunks take the vocoder's next seed (``vocoder.next_seed``, as a
    ``/clone`` does)."""
    from rtvc_tpu_torch.inference import vocoder
    from rtvc_tpu_torch.inference.streaming import stream_clone

    return stream_clone(synth, None, text, _embed(wav, sr),
                        **{"voc_seed": vocoder.next_seed(), **stream_kwargs})


class ModelServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer whose requests hand their model work to one
    long-lived thread (``on_models``). One thread does what a lock would:
    the vocoder's seed counter is shared state, and one card serves one
    request best. It also keeps the per-thread state of the libraries the
    models call: a new thread each request pays for it again (measured by
    ``profile_serve``)."""

    def __init__(self, address, handler, synth, stream_kwargs=None, ui_state=None):
        super().__init__(address, handler)
        self.synth = synth
        self.stream_kwargs = dict(stream_kwargs or {})
        self.ui_state = ui_state  # the browser toolbox's webui.UIState, or None
        self._models = ThreadPoolExecutor(max_workers=1, thread_name_prefix="models")

    def on_models(self, fn, *args):
        """``fn(*args)`` on the model thread, after the work queued before it."""
        return self._models.submit(fn, *args).result()

    def warm_clone(self) -> None:
        """One clone of a voiced test prompt, then the first two chunks of a
        stream of it, on the model thread, so that the first request does
        not pay for its layers' first pass at its shapes; the vocoder's seed
        counter is left where it was. Call it before the first request;
        ``main`` calls it after ``vocoder.warmup``."""
        from rtvc_tpu_torch.config import sp
        from rtvc_tpu_torch.inference import vocoder

        seeds = vocoder._seed, vocoder._gen_counter
        text = "A sentence to warm the models up."
        self.on_models(_clone, self.synth, voiced_prompt(), sp.sample_rate, text)
        self.on_models(_warm_stream, self.synth, voiced_prompt(), sp.sample_rate, text,
                       self.stream_kwargs)
        vocoder._seed, vocoder._gen_counter = seeds

    def server_close(self):
        super().server_close()
        self._models.shutdown()


def create_server(host: str = "127.0.0.1", port: int = 0, synth=None,
                  stream_kwargs=None, ui: bool = True, samples_dir=None) -> ModelServer:
    """A server over the models installed in the ``rtvc_tpu_torch.inference``
    encoder and vocoder modules and the synthesizer ``synth`` (a
    ``Synthesizer`` with its model). ``stream_kwargs`` go to every
    ``/stream``'s and ``/api/stream``'s ``stream_clone`` (chunk sizes and
    the like). ``ui=True`` also mounts the browser toolbox (``webui.py``)
    over the audio files of ``samples_dir`` (the repository's ``samples/``
    when None)."""
    from rtvc_tpu_torch import webui
    from rtvc_tpu_torch.config import sp
    from rtvc_tpu_torch.inference import vocoder

    sr = sp.sample_rate
    ui_state = webui.UIState(samples_dir) if ui else None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # bound socket reads and writes, so a stalled client cannot pin a worker
        timeout = 120

        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _audio(self, wav):
            body = _wav_bytes(wav, sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def _read_wav(self):
            return _parse_wav(self._read_body())

        def do_GET(self):  # noqa: N802
            if urlparse(self.path).path == "/health":
                dev = _models_device()
                return self._json({"status": "ok",
                                   "platform": None if dev is None else dev.type,
                                   "device": None if dev is None else str(dev),
                                   "synthesizer": synth is not None and synth.is_loaded(),
                                   "vocoder": vocoder.is_loaded()})
            try:
                handled = ui_state is not None and webui.handle_get(
                    self, ui_state, synth=synth, stream_kwargs=self.server.stream_kwargs)
            except BrokenPipeError:
                return
            except Exception as e:  # before the headers: answer with the error as JSON
                try:
                    self._json({"error": repr(e)[:200]}, 500)
                except OSError:
                    pass
                return
            if not handled:
                self.send_error(404)

        def do_POST(self):  # noqa: N802
            try:
                url = urlparse(self.path)
                text = (parse_qs(url.query).get("text") or [""])[0]
                if url.path == "/embed":
                    emb = self.server.on_models(_embed, *self._read_wav())
                    self._json({"embed": [float(v) for v in emb]})
                elif url.path in ("/clone", "/stream") and not text:
                    self._json({"error": "missing ?text="}, 400)
                elif url.path == "/clone":
                    self._audio(self.server.on_models(_clone, synth, *self._read_wav(), text))
                elif url.path == "/stream" and vocoder._bundle is None:
                    self._json({"error": "streaming needs the port's WaveRNN vocoder (K1) "
                                         "loaded; the native engine does not stream"}, 400)
                elif url.path == "/stream":
                    gen = self.server.on_models(_open_stream, synth, *self._read_wav(), text,
                                                self.server.stream_kwargs)
                    stream_chunked_wav(self, gen, self.server.on_models, sr)
                elif ui_state is None or not webui.handle_post(self, ui_state, synth):
                    self.send_error(404)
            except BrokenPipeError:
                pass
            except Exception as e:  # answer with the error as JSON, keep serving
                try:
                    self._json({"error": repr(e)[:200]}, 500)
                except OSError:
                    pass

    return ModelServer((host, port), Handler, synth, stream_kwargs, ui_state)


def main(argv=None) -> None:
    import argparse
    from pathlib import Path

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-e", "--enc_model_fpath", type=Path, required=True)
    parser.add_argument("-s", "--syn_model_fpath", type=Path, required=True)
    parser.add_argument("-v", "--voc_model_fpath", type=Path, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--cpu", action="store_true",
                        help="Run the models on the CPU (the default is the card).")
    parser.add_argument("--samples_dir", type=Path, default=None,
                        help="Audio dir the browser toolbox lists "
                             "(default: the in-repo samples/).")
    parser.add_argument("--no_ui", action="store_true",
                        help="API only: don't serve the browser toolbox.")
    args = parser.parse_args(argv)

    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.utils import modelutils

    missing = modelutils.missing_models(args.enc_model_fpath, args.syn_model_fpath,
                                        args.voc_model_fpath)
    if missing:
        modelutils.model_files_missing(missing)
        raise SystemExit(-1)

    device = "cpu" if args.cpu else None
    encoder.load_model(args.enc_model_fpath, device=device)
    synth = synthesizer.Synthesizer(args.syn_model_fpath, device=device)
    synth.load()
    vocoder.load_model(args.voc_model_fpath, device=device)

    server = create_server(args.host, args.port, synth=synth, ui=not args.no_ui,
                           samples_dir=args.samples_dir)
    server.on_models(vocoder.warmup)
    server.warm_clone()
    print(f"Serving on http://{args.host}:{server.server_address[1]} "
          + ("(API: " if args.no_ui else "(browser toolbox at /, API: ")
          + "/health /embed /clone /stream)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
