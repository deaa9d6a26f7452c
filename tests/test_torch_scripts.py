"""The port's copies of the seven dataset tools of ``scripts/`` that import
the JAX package (``rtvc_tpu_torch/scripts/``): each runs as ``python -m``
would run it (``runpy``) beside its original on one tiny corpus the test
writes, each in its own copy of the corpus, and the two trees end equal
byte for byte. ``ted_project``'s embeddings are within 1e-5 of the JAX
encoder's on the weights the bridge carried over, and its points are
``rtvc_tpu.utils.projection.project_2d``'s. Their sources are held to the
originals' in ``test_torch_imports.py``."""
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu.utils import mpeg as jmpeg
from rtvc_tpu.utils.projection import project_2d
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.config.encoder import EncoderDataParams, EncoderModelParams
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from rtvc_tpu_torch.scripts import ted_project
from rtvc_tpu_torch.train.checkpoints import save_checkpoint
from rtvc_tpu_torch.utils import mpeg as tmpeg
from rtvc_tpu_torch.utils import libav
from rtvc_tpu_torch.utils.io import save_wav_float

REPO = Path(__file__).resolve().parents[1]
SR = 16000
ENC = EncoderModelParams(model_hidden_size=32, model_embedding_size=24, model_num_layers=2)


def tone(seconds, sr=SR, f=220.0, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(t.size)).astype(
        np.float32)


def save(wav: np.ndarray, path: Path, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_wav_float(wav, path, sr)


def sphere(path: Path, wav: np.ndarray, sr=SR):
    """A NIST SPHERE file of 16-bit PCM."""
    pcm = (wav * 32767).astype("<i2").tobytes()
    header = ("NIST_1A\n   1024\n"
              f"sample_rate -i {sr}\nchannel_count -i 1\nsample_n_bytes -i 2\n"
              f"sample_count -i {len(wav)}\n"
              "sample_byte_format -s2 01\nsample_coding -s3 pcm\nend_head\n").encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header + b" " * (1024 - len(header)) + pcm)


def need_codec():
    if not libav.libav_supported():
        pytest.skip("the codec shim does not build here")


def commonvoice(root: Path):
    need_codec()
    lang = root / "cv" / "it"
    (lang / "clips").mkdir(parents=True)
    rows = ["client_id\tpath\tsentence\tup_votes\tdown_votes\tage\tgender\taccent"]
    for i, cid in enumerate(("a" * 64, "b" * 64, "a" * 64)):
        libav.encode_audio(lang / "clips" / f"clip_{i}.mp3",
                           tone(1.0 + 0.3 * i, f=300 + 50 * i), SR)
        rows.append(f"{cid}\tclip_{i}.mp3\tFrase numero {i}\t1\t0\t\t\t")
    rows.append(f"{'c' * 64}\tmissing.mp3\tNon c'e\t1\t0\t\t\t")
    (lang / "validated.tsv").write_text("\n".join(rows) + "\n")
    # each package's libmpg123 loaded on this thread before the scripts'
    # two threads decode: both packages' ``utils/mpeg._load_mpg123`` mark the
    # library checked before it is loaded, so a thread that asks meanwhile
    # is told it is missing and ``load_wav`` decodes that clip with FFmpeg's
    # mp3 decoder, whose samples are ~1.5e-6 from libmpg123's (a flac
    # sample's last bit). Loaded once, every clip goes through libmpg123
    for mpeg in (jmpeg, tmpeg):
        mpeg.mpeg_supported()
    return ["cv", "--lang", "it", "-t", "2"]


def convert_audio(root: Path):
    save(tone(1.2, 22050), root / "a" / "x.wav", 22050)
    save(tone(0.7, 44100, f=500), root / "b" / "y.wav", 44100)
    save(tone(0.5), root / "b" / "z.wav", SR)
    return [".", "--sr", "16000"]


def tedlium(root: Path):
    save(tone(4.0), root / "legacy" / "Talk_A.wav", SR)
    (root / "legacy" / "Talk_A.stm").write_text(
        "Talk_A 1 Talk_A_spk 0.2 1.4 <o,f0,male> first <unk> segment\n"
        "Talk_A 1 Talk_A_spk 1.5 1.7 <o,f0,male> too short\n"
        "Talk_A 1 Talk_A_spk 2.0 3.5 <o,f0,male> ignore_time_segment_in_scoring\n"
        "Talk_A 1 Talk_A_spk 2.1 3.9 <o,f0,male> second segment here\n")
    sphere(root / "legacy" / "Talk_B.sph", tone(1.0))
    (root / "legacy" / "Talk_B.stm").write_text("Talk_B 1 B 0.0 0.9 <o> needs ffmpeg\n")
    return ["."]


def tedlium_transcript(root: Path):
    need_codec()
    sphere(root / "sph" / "AlGore_2009.sph", tone(3.0))
    sphere(root / "sph" / "Other_2010.sph", tone(2.0, f=330))
    (root / "stm").mkdir()
    (root / "stm" / "AlGore_2009.stm").write_text(
        "AlGore_2009 1 AlGore 0.2 1.2 <o,f0,male> thank you so much chris\n"
        ";; a comment\n"
        "AlGore_2009 1 AlGore 1.5 2.8 <o,f0,male> and it is <unk> truly a great honor\n")
    return [".", "-t", "2"]


def tedx_speakers(root: Path):
    save(tone(10.0), root / "wav" / "talk01.wav", SR)
    save(tone(4.0, f=410), root / "wav" / "talk02.wav", SR)
    (root / "vtt").mkdir()
    cues = "".join(f"00:00:0{i}.000 --> 00:00:0{i}.800\nFrase {i}\n\n" for i in range(1, 8))
    (root / "vtt" / "talk01.es.vtt").write_text("WEBVTT\n\n" + cues)
    (root / "vtt" / "talk02.es.vtt").write_text(
        "WEBVTT\n\n00:00:01.000 --> 00:00:02.000\nSolo una\n")
    return [".", "--min", "2", "--max", "5", "--seed", "3"]


def timit(root: Path):
    for spk, f in (("FAKS0", 200.0), ("MDAB0", 120.0)):
        for utt in ("SA1", "SX2"):
            sphere(root / "TRAIN" / "DR1" / spk / f"{utt}.WAV", tone(1.0, f=f))
            (root / "TRAIN" / "DR1" / spk / f"{utt}.TXT").write_text(
                f"0 16000 She had your dark suit {spk} {utt}.\n")
    sphere(root / "TRAIN" / "DR1" / "FAKS0" / "SI3.WAV", tone(0.5))  # no transcript
    return ["."]


CORPORA = {"commonvoice_transcript": commonvoice, "convert_audio": convert_audio,
           "tedlium": tedlium, "tedlium_transcript": tedlium_transcript,
           "tedx_speakers": tedx_speakers, "timit": timit}


def run_original(name, argv, monkeypatch, cwd):
    monkeypatch.chdir(cwd)
    monkeypatch.syspath_prepend(str(REPO / "scripts"))  # tedlium_transcript's ``stm``
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return runpy.run_path(str(REPO / "scripts" / f"{name}.py"), run_name="__main__")


def run_copy(name, argv, monkeypatch, cwd):
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return runpy.run_module(f"rtvc_tpu_torch.scripts.{name}", run_name="__main__")


def files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_copy_writes_what_its_original_writes(name, tmp_path, monkeypatch):
    argv = CORPORA[name](tmp_path / "corpus")
    for tree in ("original", "copy"):
        shutil.copytree(tmp_path / "corpus", tmp_path / tree)
    with monkeypatch.context() as mp:
        run_original(name, argv, mp, tmp_path / "original")
    with monkeypatch.context() as mp:
        run_copy(name, argv, mp, tmp_path / "copy")
    got, want = files(tmp_path / "copy"), files(tmp_path / "original")
    assert got == want and len(want) > len(files(tmp_path / "corpus"))
    for rel in want:
        got_bytes = (tmp_path / "copy" / rel).read_bytes()
        assert got_bytes == (tmp_path / "original" / rel).read_bytes(), rel


def test_copies_run_as_modules(tmp_path):
    argv = timit(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "rtvc_tpu_torch.scripts.timit", *argv],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Wrote 4 utterances" in proc.stdout
    assert "jax" not in proc.stderr


@pytest.fixture
def encoders(monkeypatch):
    """The JAX encoder's inference state at ENC's widths (its random model
    from seed 0, as the original script installs it) and the port's, both
    restored after the test."""
    for mod, names in ((jenc, ("_model_cfg", "_model", "_params")),
                       (tenc, ("_model", "_model_cfg", "_data"))):
        for n in names:
            monkeypatch.setattr(mod, n, getattr(mod, n))
    monkeypatch.setattr(jenc, "_model_cfg", JEncoderModelParams(**ENC.asdict()))
    monkeypatch.setattr(jenc, "_model", None)


def test_ted_project_embeds_as_the_jax_encoder(tmp_path, monkeypatch, encoders):
    root = tmp_path / "speakers"
    for s, f in enumerate((140.0, 260.0)):
        for u in range(3):
            save(tone(1.5 + 0.25 * u, f=f + 15 * u, seed=u), root / f"spk{s}" / f"u{u}.wav")
    with monkeypatch.context() as mp:
        want = run_original("ted_project", [str(root), "-o", str(tmp_path / "jax.png")], mp,
                            tmp_path)
    # the weights the original drew, carried over into a checkpoint of the port
    model = SpeakerEncoder(ENC)
    model.load_state_dict(bridge.speaker_encoder_state(jenc._params))
    ckpt = tmp_path / "encoder.pt"
    save_checkpoint(ckpt, model, 0, "speaker_encoder",
                    extras={"config": {"model": ENC.asdict(),
                                       "data": EncoderDataParams().asdict()}})
    embeds, speakers, pts = ted_project.main([str(root), "-m", str(ckpt), "-o",
                                              str(tmp_path / "port.png"), "--device", "cpu"])
    assert speakers == want["speakers"] and embeds.shape == (6, ENC.model_embedding_size)
    np.testing.assert_allclose(embeds, want["embeds"], atol=1e-5)
    np.testing.assert_array_equal(pts, project_2d(embeds))
    assert (tmp_path / "port.png").stat().st_size > 1000


def test_ted_project_names_matplotlib_where_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pts = np.zeros((2, 2))
    with pytest.raises(ImportError, match="matplotlib"):
        ted_project.save_projection(pts, ["a", "b"], tmp_path / "p.png")
    assert not (tmp_path / "p.png").exists()
