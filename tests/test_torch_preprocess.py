"""The SV2TTS preprocessing passes of the port against the JAX package's, on
the CPU, on a tiny corpus: three speakers of two 2.5 s utterances (one
speaker written at 22 050 Hz, resampled on load), one utterance that the
audio pass drops (0.4 s: under ``utterance_min_duration``) and one whose
transcript is under ``min_text_len``.

The JAX passes are held function by function (the JAX package's own whole
three-pass test takes about 40 s); the port's passes run whole. Tolerances:

- encoder pass: ``_sources.txt`` equal, frames within 1e-4 absolute (the
  encoder frontend's tolerance in ``test_torch_lstm.py``), ``Log_*.txt``
  equal line for line but for the two dated lines;
- audio pass: ``train.json`` equal as a dict, ``wav/`` files equal in bits,
  mels within 2e-4 absolute on the normalised [-4, 4] scale (K6's and
  ``melspectrogram``'s tolerance in ``test_torch_dsp.py``); the port's pass
  on one thread and on two: ``train.json`` and the wavs equal in bits, the
  mels within 1e-5 (on the CPU the mel product's sums follow the OpenMP
  threads of the thread that calls it; on the card K6 gives the same bits,
  ``tests/test_torch_cuda.py``);
- embedding pass, at a narrow encoder (hidden 32, two layers) bridged from
  the JAX weights: embeddings within 1e-4 absolute (``test_torch_lstm.py``);
- ``split_on_silences``: the same segments and texts, wavs within 1e-6
  absolute (the same numpy code on the same samples);
- ``trim_silence``, ``logmmse.profile_noise`` and ``denoise``: equal in bits.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu.data import encoder_preprocess as jep
from rtvc_tpu.data import synthesizer_preprocess as jsp
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu.ops import logmmse as jlogmmse
from rtvc_tpu.ops import vad as jvad
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch import encoder_preprocess as tep_main
from rtvc_tpu_torch import synthesizer_preprocess_audio as audio_main
from rtvc_tpu_torch import synthesizer_preprocess_embeds as embeds_main
from rtvc_tpu_torch.config.encoder import EncoderModelParams
from rtvc_tpu_torch.data import encoder_preprocess as tep
from rtvc_tpu_torch.data import synthesizer_preprocess as tsp
from rtvc_tpu_torch.data.ge2e_sampler import SpeakerVerificationDataset
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.ops import logmmse as tlogmmse
from rtvc_tpu_torch.ops import vad as tvad
from rtvc_tpu_torch.utils.io import save_wav_float

SR = 16000
NARROW = EncoderModelParams(model_hidden_size=32, model_embedding_size=768, model_num_layers=2)
KEPT = 6  # utterances the audio pass keeps: three speakers x two


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: the passes' own thread pools beside the other
    test workers make more OpenMP threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _voiced(seconds, sr, freq, rng):
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * freq * t) + 0.2 * np.sin(2 * np.pi * 3 * freq * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def make_corpus(root: Path) -> Path:
    """``<root>/datasets/TinyCorpus/speakers/spk{0,1,2}`` (spk2 at 22 050
    Hz), two kept utterances each, spk0's 0.4 s ``short`` dropped by the
    audio pass and spk1's ``terse`` skipped for its transcript. Returns the
    datasets root."""
    rng = np.random.default_rng(0)
    speakers = root / "datasets" / "TinyCorpus" / "speakers"
    for s, sr in enumerate((SR, SR, 22050)):
        d = speakers / f"spk{s}"
        d.mkdir(parents=True)
        for u in range(2):
            save_wav_float(_voiced(2.5, sr, 120 + 60 * s + 10 * u, rng), d / f"utt{u}.wav", sr)
            (d / f"utt{u}.txt").write_text(f"sample text number {u}")
    save_wav_float(_voiced(0.4, SR, 200, rng), speakers / "spk0" / "short.wav", SR)
    (speakers / "spk0" / "short.txt").write_text("too short to keep")
    save_wav_float(_voiced(2.0, SR, 210, rng), speakers / "spk1" / "terse.wav", SR)
    (speakers / "spk1" / "terse.txt").write_text("a")
    return root / "datasets"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _audio_pass(datasets, out, n_processes=2, **kw):
    return tsp.synthesizer_preprocess_dataset(datasets, out, "TinyCorpus", ["speakers"],
                                              [".wav"], ".txt", n_processes=n_processes,
                                              device="cpu", **kw)


@pytest.fixture(scope="module")
def port_root(corpus, tmp_path_factory):
    """The port's audio pass over the corpus on two threads."""
    out = tmp_path_factory.mktemp("syn")
    assert _audio_pass(corpus, out) == KEPT
    return out


def _speaker_dirs(corpus):
    return sorted(p for p in (corpus / "TinyCorpus" / "speakers").iterdir() if p.is_dir())


# ---------------------------------------------------------------------------
# Encoder preprocessing
# ---------------------------------------------------------------------------


def _log_lines(path):
    lines = path.read_text().splitlines()
    assert lines[0].startswith("Creating dataset") and lines[-1].startswith("Finished on")
    return lines[1:-1]


def test_encoder_pass_matches_jax_on_one_speaker(corpus, tmp_path):
    spk = _speaker_dirs(corpus)[2]  # the 22 050 Hz speaker: the resample on load
    outs = {}
    for name, mod in (("jax", jep), ("port", tep)):
        out = tmp_path / name
        mod.preprocess_speaker_dirs([spk], "TinyCorpus", corpus, out, (".wav",), False,
                                    n_threads=1)
        outs[name] = out / spk.name
    j, t = outs["jax"], outs["port"]
    assert (t / "_sources.txt").read_text() == (j / "_sources.txt").read_text()
    fj, ft = np.load(j / "combined.npz"), np.load(t / "combined.npz")
    assert sorted(ft.files) == sorted(fj.files) == ["frames_0.npy", "frames_1.npy"]
    for k in fj.files:
        assert ft[k].shape == fj[k].shape and ft[k].dtype == np.float32
        np.testing.assert_allclose(ft[k], fj[k], atol=1e-4, err_msg=k)
    assert _log_lines(tmp_path / "port" / "Log_TinyCorpus.txt") == \
        _log_lines(tmp_path / "jax" / "Log_TinyCorpus.txt")


def test_encoder_entry_module_writes_what_the_sampler_reads(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(tep_main, "dataset_paths", lambda: {"tiny": ["TinyCorpus/speakers"]})
    out = tmp_path / "enc"
    kept = tep_main.main([str(corpus), "-o", str(out), "-d", "tiny,unknown", "-t", "3"])
    assert kept == 7  # every utterance of 2 s or more has a partial's frames
    assert sorted(p.parent.name for p in out.glob("*/combined.npz")) == ["spk0", "spk1", "spk2"]
    assert (out / "Log_tiny.txt").read_text().count("duration:") == 1
    dataset = SpeakerVerificationDataset(out)
    assert len(dataset.speakers) == 3
    assert dataset.speakers[0].random_partial(2, 20)[0][1].shape == (20, 40)
    # --skip_existing leaves every speaker's files as they are
    stamps = {p: p.stat().st_mtime_ns for p in out.glob("*/combined.npz")}
    assert tep_main.main([str(corpus), "-o", str(out), "-d", "tiny", "-s"]) == 0
    assert {p: p.stat().st_mtime_ns for p in out.glob("*/combined.npz")} == stamps


def test_encoder_entry_module_knows_the_jax_dataset_names():
    from rtvc_tpu.config import datasets as jreg

    paths = tep_main.dataset_paths()
    assert paths["librispeech_other"] == jreg.librispeech_datasets["train"]["other"]
    assert paths["voxceleb2"] == jreg.voxceleb_datasets["voxceleb2"]["train"]
    assert paths["vctk"] == jreg.other_datasets["VCTK"]
    assert paths["commonvoice-7-en"] == jreg.commonvoice_datasets["commonvoice-7"]["en"]
    assert {**jreg.slr_datasets_wav, **jreg.slr_datasets_flac}.items() <= paths.items()
    assert len(paths) == 10 + len(jreg.slr_datasets_wav) + len(jreg.slr_datasets_flac)
    assert tep_main.parse_args(["root"]).datasets == "librispeech_other,voxceleb1,voxceleb2"


# ---------------------------------------------------------------------------
# Pass 1: audio
# ---------------------------------------------------------------------------


def test_process_utterance_matches_jax(corpus, tmp_path):
    from rtvc_tpu_torch.utils.io import load_wav

    speakers = _speaker_dirs(corpus)
    cases = [speakers[0] / "utt0.wav", speakers[2] / "utt1.wav", speakers[0] / "short.wav"]
    for name in ("jax", "port"):
        for d in ("mels", "wav"):
            (tmp_path / name / d).mkdir(parents=True)
    for path in cases:
        wav, _ = load_wav(path, target_sr=SR)
        wav = wav / np.abs(wav).max() * 0.9
        uid = f"{path.parent.name}_{path.stem}"
        want = jsp.process_utterance(uid, wav, "some text", tmp_path / "jax")
        got = tsp.process_utterance(uid, wav, "some text", tmp_path / "port", device="cpu")
        assert got == want
        if want is None:
            assert path.stem == "short"
            continue
        for d, stem in (("wav", "audio"), ("mels", "mel")):
            a = np.load(tmp_path / "port" / d / f"{stem}-{uid}.npy")
            b = np.load(tmp_path / "jax" / d / f"{stem}-{uid}.npy")
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            if d == "wav":
                assert a.tobytes() == b.tobytes()
            else:
                np.testing.assert_allclose(a, b, atol=2e-4)


def test_audio_pass_matches_jax(corpus, port_root, tmp_path):
    """The port's whole pass against the JAX pass's per-speaker function,
    assembled into ``train.json`` as the JAX pass does."""
    jroot = tmp_path / "jax"
    for d in ("mels", "wav"):
        (jroot / d).mkdir(parents=True)
    want = {}
    for spk in _speaker_dirs(corpus):
        result = jsp.preprocess_speaker(spk, jroot, [".wav"], ".txt")
        want[result["speaker_dir"]] = ["|".join(str(x) for x in m) for m in result["metadata"]]
    got = json.loads((port_root / "train.json").read_text())
    assert got == want
    assert sum(len(v) for v in got.values()) == KEPT
    assert not any("short" in line or "terse" in line for v in got.values() for line in v)
    for uid in (line.split("|")[0] for v in want.values() for line in v):
        a = np.load(port_root / "wav" / f"audio-{uid}.npy")
        assert a.tobytes() == np.load(jroot / "wav" / f"audio-{uid}.npy").tobytes(), uid
        m = np.load(port_root / "mels" / f"mel-{uid}.npy")
        np.testing.assert_allclose(m, np.load(jroot / "mels" / f"mel-{uid}.npy"), atol=2e-4,
                                   err_msg=uid)
        assert m.shape[1] == 80


def test_audio_pass_on_one_thread_equals_two(corpus, port_root, tmp_path):
    out = tmp_path / "one"
    assert _audio_pass(corpus, out, n_processes=1) == KEPT
    assert (out / "train.json").read_text() == (port_root / "train.json").read_text()
    for d in ("wav", "mels"):
        names = sorted(p.name for p in (port_root / d).iterdir())
        assert names == sorted(p.name for p in (out / d).iterdir()) and len(names) == KEPT
        for n in names:
            a, b = np.load(out / d / n), np.load(port_root / d / n)
            if d == "wav":
                assert a.tobytes() == b.tobytes(), n
            else:  # the CPU product's sums follow the calling thread's OpenMP threads
                np.testing.assert_allclose(a, b, atol=1e-5, err_msg=n)


def test_audio_pass_skip_existing_and_backup(corpus, port_root, tmp_path):
    import shutil

    out = tmp_path / "again"
    shutil.copytree(port_root, out)
    before = (out / "train.json").read_text()
    # skip_existing: every speaker is in train.json, so nothing is redone
    stamps = {p: p.stat().st_mtime_ns for p in (out / "mels").iterdir()}
    assert _audio_pass(corpus, out, skip_existing=True) == KEPT
    assert {p: p.stat().st_mtime_ns for p in (out / "mels").iterdir()} == stamps
    assert not list(out.glob("train_backup_*.json"))
    # a second pass without it backs the old train.json up and writes it anew
    assert _audio_pass(corpus, out) == KEPT
    [backup] = out.glob("train_backup_*.json")
    assert backup.read_text() == before == (out / "train.json").read_text()


def test_audio_pass_saves_its_metadata_when_a_speaker_fails(corpus, tmp_path, monkeypatch):
    """A failure inside the pool leaves the pass's ``atexit`` save
    registered, holding the speakers finished before it."""
    registered = []

    class FakeAtexit:
        @staticmethod
        def register(fn, *args):
            registered.append((fn, args))

        @staticmethod
        def unregister(fn):
            registered[:] = [r for r in registered if r[0] is not fn]

    real = tsp.preprocess_speaker

    def failing(speaker_dir, *args):
        if Path(speaker_dir).name == "spk1":
            raise OSError("disk gone")
        return real(speaker_dir, *args)

    monkeypatch.setattr(tsp, "atexit", FakeAtexit)
    monkeypatch.setattr(tsp, "preprocess_speaker", failing)
    out = tmp_path / "crash"
    with pytest.raises(OSError, match="disk gone"):
        _audio_pass(corpus, out, n_processes=1)
    assert not (out / "train.json").exists()
    [(fn, args)] = registered
    fn(*args)  # what the interpreter runs at exit
    saved = json.loads((out / "train.json").read_text())
    assert [Path(k).name for k in saved] == ["spk0"] and len(saved[next(iter(saved))]) == 2


def test_audio_entry_module_runs_on_the_card_by_default(corpus, tmp_path, monkeypatch):
    from rtvc_tpu_torch.config import datasets

    monkeypatch.setitem(datasets.synthesizer_datasets, "TinyCorpus", {
        "directories": ["speakers"], "audio_extensions": [".wav"],
        "transcript_extension": ".txt"})
    args = [str(corpus), "-o", str(tmp_path / "syn"), "-d", "TinyCorpus", "-n", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            audio_main.main(args)
        assert not (tmp_path / "syn" / "train.json").exists()
    assert audio_main.main(args + ["--device", "cpu"]) == KEPT
    assert len(list((tmp_path / "syn" / "mels").glob("mel-*.npy"))) == KEPT


# ---------------------------------------------------------------------------
# Pass 2: embeddings
# ---------------------------------------------------------------------------


@pytest.fixture
def narrow_encoders(monkeypatch):
    """Both encoder inference modules hold the same narrow random model."""
    from rtvc_tpu.models.speaker_encoder import SpeakerEncoder, import_torch_state
    from rtvc_tpu_torch.models import factories

    model = factories.init_encoder_model(seed=3, device="cpu", model_cfg=NARROW)
    jcfg = JEncoderModelParams(**NARROW.asdict())
    # the JAX module and the port's weights (the JAX initialiser takes
    # seconds op by op)
    monkeypatch.setattr(jenc, "_model_cfg", jcfg)
    monkeypatch.setattr(jenc, "_model", SpeakerEncoder(model=jcfg, data=jenc._data))
    monkeypatch.setattr(jenc, "_params", {"params": import_torch_state(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})["params"]})
    for name in ("_model", "_model_cfg", "_data"):  # load_state and load_model set them
        monkeypatch.setattr(tenc, name, getattr(tenc, name))
    tenc.load_state(bridge.speaker_encoder_state(jenc._params), device="cpu", model_cfg=NARROW)
    return model


def _copy_audio_pass(port_root, dst):
    import shutil

    shutil.copytree(port_root, dst, ignore=shutil.ignore_patterns("embeds"))
    return dst


def test_embedding_pass_matches_jax(narrow_encoders, port_root, tmp_path):
    roots = {name: _copy_audio_pass(port_root, tmp_path / name) for name in ("jax", "port")}
    jsp.create_embeddings(roots["jax"], None, n_processes=2)
    assert tsp.create_embeddings(roots["port"], None, n_processes=2) == KEPT
    names = sorted(p.name for p in (roots["jax"] / "embeds").iterdir())
    assert names == sorted(p.name for p in (roots["port"] / "embeds").iterdir())
    assert len(names) == KEPT
    for n in names:
        a, b = (np.load(roots[k] / "embeds" / n) for k in ("port", "jax"))
        assert a.shape == b.shape == (768,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=n)


def test_embedding_pass_threads_and_skip_existing(narrow_encoders, port_root, tmp_path):
    one = _copy_audio_pass(port_root, tmp_path / "one")
    four = _copy_audio_pass(port_root, tmp_path / "four")
    assert tsp.create_embeddings(one, None, n_processes=1) == KEPT
    assert tsp.create_embeddings(four, None, n_processes=4) == KEPT
    for p in (one / "embeds").iterdir():
        assert p.read_bytes() == (four / "embeds" / p.name).read_bytes(), p.name
    victim = next((four / "embeds").iterdir())
    victim.unlink()
    assert tsp.create_embeddings(four, None, skip_existing=True) == 1
    assert victim.read_bytes() == (one / "embeds" / victim.name).read_bytes()


def test_embeds_entry_module_loads_a_checkpoint(narrow_encoders, port_root, tmp_path,
                                                monkeypatch):
    from rtvc_tpu_torch.train.checkpoints import save_checkpoint

    ckpt = tmp_path / "encoder.pt"
    save_checkpoint(ckpt, narrow_encoders, 7, "encoder",
                    extras={"config": {"model": NARROW.asdict(),
                                       "data": narrow_encoders.data_cfg.asdict()}})
    want = _copy_audio_pass(port_root, tmp_path / "want")
    tsp.create_embeddings(want, None, n_processes=1)  # the installed narrow encoder
    monkeypatch.setattr(tenc, "_model", None)
    root = _copy_audio_pass(port_root, tmp_path / "syn")
    args = [str(root), "-e", str(ckpt), "-n", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            embeds_main.main(args)
        assert not tenc.is_loaded()
    assert embeds_main.main(args + ["--device", "cpu"]) == KEPT
    for p in (want / "embeds").iterdir():
        np.testing.assert_allclose(np.load(root / "embeds" / p.name), np.load(p), atol=1e-6)
    monkeypatch.setattr(tenc, "_model", None)
    with pytest.raises(RuntimeError, match="no weights found"):
        tsp.create_embeddings(root, tmp_path / "missing.pt", device="cpu")


# ---------------------------------------------------------------------------
# The numpy helpers: silence splitting, trimming, log-MMSE
# ---------------------------------------------------------------------------


def test_split_on_silences_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    words, ends, pieces = [], [], []
    t_end = 0.0
    # ["", w, w, "", w, ..., ""]: silences of 0.2 s (kept inside a segment)
    # and 0.5 s (a split), words of 0.3-0.9 s
    for k, (word, seconds) in enumerate([("", 0.5), ("hello", 0.9), ("there", 0.4), ("", 0.2),
                                         ("voice", 0.6), ("", 0.5), ("a", 0.3), ("", 0.5),
                                         ("cloning", 1.2), ("works", 0.8), ("", 0.5)]):
        n = int(round(seconds * SR))
        piece = (0.003 * rng.standard_normal(n) if word == "" else
                 0.3 * np.sin(2 * np.pi * (150 + 20 * k) * np.arange(n) / SR))
        pieces.append(piece.astype(np.float32))
        t_end += n / SR
        words.append(word)
        ends.append(t_end)
    path = tmp_path / "long.wav"
    save_wav_float(np.concatenate(pieces), path, SR)
    got_w, got_t = tsp.split_on_silences(path, words, ends)
    want_w, want_t = jsp.split_on_silences(path, words, ends)
    assert got_t == want_t and len(got_t) >= 2
    assert "a" in " ".join(got_t)  # the 0.3 s word was merged into a neighbour
    for a, b in zip(got_w, want_w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6)
    # no silence at either end: the whole utterance and its transcript
    [w], [t] = tsp.split_on_silences(path, ["x", "y"], [1.0, ends[-1]], transcript="X Y")
    [jw], [jt] = jsp.split_on_silences(path, ["x", "y"], [1.0, ends[-1]], transcript="X Y")
    assert t == jt == "X Y" and np.array_equal(w, jw)


@pytest.mark.parametrize("top_db", [20.0, 60.0])
def test_trim_silence_equals_jax(top_db):
    rng = np.random.default_rng(int(top_db))
    wav = np.concatenate([1e-4 * rng.standard_normal(7000),
                          0.5 * np.sin(np.arange(20000) * 0.07),
                          1e-3 * rng.standard_normal(9000)]).astype(np.float32)
    got = tvad.trim_silence(wav, top_db)
    assert got.tobytes() == jvad.trim_silence(wav, top_db).tobytes()
    assert 20000 <= len(got) < len(wav)
    assert len(tvad.trim_silence(np.zeros(0, np.float32))) == 0


def test_logmmse_equals_jax():
    rng = np.random.default_rng(5)
    t = np.arange(2 * SR) / SR
    noise = 0.05 * rng.standard_normal(len(t)).astype(np.float32)
    noisy = 0.5 * np.sin(2 * np.pi * 300 * t).astype(np.float32) + noise
    tp, jp = tlogmmse.profile_noise(noise[:SR // 2], SR), jlogmmse.profile_noise(noise[:SR // 2],
                                                                                 SR)
    assert (tp.sample_rate, tp.frame_len, tp.hop) == (jp.sample_rate, jp.frame_len, jp.hop)
    assert tp.noise_power.tobytes() == jp.noise_power.tobytes()
    for eta in (0.0, 0.15):
        got = tlogmmse.denoise(noisy, tp, eta=eta)
        assert got.tobytes() == jlogmmse.denoise(noisy, jp, eta=eta).tobytes()
