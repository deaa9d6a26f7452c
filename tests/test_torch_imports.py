"""The port stands on its own: ``rtvc_tpu_torch`` and ``chip_smoke`` import
none of ``jax``, ``flax``, ``msgpack`` and ``rtvc_tpu``, and the modules the
port copied from the JAX package (config with the dataset registry, text,
the three dataset modules, metrics, the duration extractor, the F0 tracker,
the t-SNE projection, the VAD, log-MMSE, the mpg123 binding, the codec
shim's C source, the WaveRNN engine's C++ sources, its RTVCNAT1 format
helpers and ctypes binding, the TUI and the browser toolbox's page) still
say what their originals say: equal config fields and values, equal symbol sequences, equal
batches from one tiny on-disk dataset and seed (the non-autoregressive
synthesizers' batches from a root the alignment pass wrote too), and the
copied functions' sources equal their originals' but for the imports (their
values on seeded inputs: ``test_torch_align.py``; the trainers' dashboard
and argument printer: ``test_torch_dashboard.py``)."""
import dataclasses
import inspect
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import rtvc_tpu.config as jcfg
import rtvc_tpu.config.datasets  # noqa: F401  (the JAX package's, for the field comparison)
import rtvc_tpu_torch.config as tcfg
from rtvc_tpu import text as jtext
from rtvc_tpu.data import ge2e_sampler as jge2e
from rtvc_tpu.data import synthesizer_dataset as jsyn
from rtvc_tpu.data import vocoder_dataset as jvoc
from rtvc_tpu.utils import metrics as jmetrics
from rtvc_tpu_torch import text as ttext
from rtvc_tpu_torch.data import ge2e_sampler as tge2e
from rtvc_tpu_torch.data import synthesizer_dataset as tsyn
from rtvc_tpu_torch.data import vocoder_dataset as tvoc
from rtvc_tpu_torch.models import factories as tfactories
from rtvc_tpu_torch.utils import metrics as tmetrics

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
assert "jax" not in sys.modules, "the interpreter starts with jax imported"
import rtvc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtvc_tpu_torch.__path__, "rtvc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for need in ("models.distribution", "ops.stft", "ops.mel_project", "ops.wavernn_generate",
             "inference.vocoder", "inference.synthesizer", "vocoder_train",
             "utils.flax_msgpack", "utils.modelutils", "train.checkpoints", "serve",
             "demo_cli", "inference.streaming", "inference.pipelined", "profile_stream",
             "models.forward_tacotron", "models.fast_pitch", "inference.attention",
             "data.duration_extractor", "data.synthesizer_preprocess", "ops.pitch",
             "synthesizer_preprocess_alignments", "train.gta", "train.gen_testset",
             "train.eval_hooks", "utils.plots", "utils.projection", "vocoder_preprocess",
             "ops.precision", "utils.argutils", "utils.dashboard", "utils.genquality",
             "config.datasets", "ops.logmmse", "utils.mpeg", "utils.libav",
             "data.encoder_preprocess", "encoder_preprocess", "synthesizer_preprocess_audio",
             "synthesizer_preprocess_embeds", "toolbox", "webui", "tui", "demo_toolbox",
             "native.convert", "native.libwavernn", "vocoder_convert_model",
             "vocoder_check_libwavernn"):
    assert "rtvc_tpu_torch." + need in names, need
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "rtvc_tpu", "flax", "msgpack"))
print(len(names), "modules;", "foreign:", bad)
sys.exit(1 if bad or len(names) < 63 else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]


def test_port_sources_name_no_jax_import():
    pattern = ("from rtvc_tpu ", "from rtvc_tpu.", "import rtvc_tpu ", "import rtvc_tpu.",
               "import rtvc_tpu\n", "import jax", "from jax")
    files = sorted((REPO / "rtvc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 60
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(keepends=True), 1):
            code = line.strip()
            assert not code.startswith(pattern), f"{f.relative_to(REPO)}:{n}: {code}"


@pytest.mark.parametrize("name", [n for n in jcfg.__all__ if n != "Config"])
def test_config_copies_equal_their_originals(name):
    want, got = getattr(jcfg, name), getattr(tcfg, name)
    if isinstance(want, type):
        assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
            [(f.name, f.type) for f in dataclasses.fields(want)]
        want, got = want(), got()
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        assert got.asdict() == want.asdict()
        assert type(got).__module__.startswith("rtvc_tpu_torch.")
    else:
        assert got == want


def test_config_override_parser_is_the_same():
    for spec in ("decoder_dims=64,max_r=5", "tts_clip_grad_norm=0.5"):
        assert tcfg.tacotron.parse(spec).asdict() == jcfg.tacotron.parse(spec).asdict()


SENTENCES = ["Dr. Smith paid $3.50 for 2 apples on May 1st, 1999.",
             "Mr. and Mrs. Jones live at No. 221, 3rd floor; call 1,000 times!",
             "Plain text, with punctuation: yes? No... (maybe) \"quoted\".",
             "Café déjà vu costs £12 & 40% more in 2024.",
             ""]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_text_copies_agree(sentence):
    assert ttext.symbols == jtext.symbols
    names = tcfg.preprocessing.cleaner_names
    want = jtext.text_to_sequence(sentence, names)
    assert ttext.text_to_sequence(sentence, names) == want
    assert ttext.sequence_to_text(want) == jtext.sequence_to_text(want)


def _batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_synthesizer_dataset_copy_yields_the_same_batches(tmp_path):
    from test_torch_taco_train import _make_syn_dataset

    root = _make_syn_dataset(tmp_path / "syn", 7)
    out = []
    for mod in (jsyn, tsyn):
        ds = mod.SynthesizerDataset(root, ["mel", "embed"])
        it = mod.batch_iterator(ds, batch_size=2, r=3, seed=5)
        out.append((len(it), [b for _ in range(2) for b in it], ds.get_logs()))
    assert out[0][0] == out[1][0] == 3 and out[0][2] == out[1][2]
    for a, b in zip(out[0][1], out[1][1]):
        _batches_equal(a, b)
    assert out[1][1][0]["mels"].shape[2] % 3 == 0 and out[1][1][0]["chars"].shape[1] % 32 == 0


def test_synthesizer_dataset_copy_yields_the_same_nar_batches(tmp_path):
    from test_torch_align import aligned_root

    root = aligned_root(tmp_path / "syn", 5)
    elements = tfactories.get_model_train_elements("forward-tacotron")
    out = []
    for mod in (jsyn, tsyn):
        it = mod.batch_iterator(mod.SynthesizerDataset(root, elements), batch_size=2, r=1,
                                seed=3)
        out.append([b for _ in range(2) for b in it])
    assert len(out[0]) == len(out[1]) == 4
    for a, b in zip(*out):
        _batches_equal(a, b)
    assert {"durations", "phoneme_pitchs", "phoneme_energys", "attentions",
            "alignments"} <= set(out[1][0])


@pytest.mark.parametrize("copy,original", [
    ("rtvc_tpu_torch/data/duration_extractor.py", "rtvc_tpu/data/duration_extractor.py"),
    ("rtvc_tpu_torch/ops/pitch.py", "rtvc_tpu/ops/pitch.py"),
    ("rtvc_tpu_torch/utils/projection.py", "rtvc_tpu/utils/projection.py"),
    ("rtvc_tpu_torch/utils/argutils.py", "rtvc_tpu/utils/argutils.py"),
    ("rtvc_tpu_torch/utils/dashboard.py", "rtvc_tpu/utils/dashboard.py"),
    ("rtvc_tpu_torch/config/datasets.py", "rtvc_tpu/config/datasets.py"),
    ("rtvc_tpu_torch/ops/vad.py", "rtvc_tpu/ops/vad.py"),
    ("rtvc_tpu_torch/ops/logmmse.py", "rtvc_tpu/ops/logmmse.py"),
    ("rtvc_tpu_torch/utils/mpeg.py", "rtvc_tpu/utils/mpeg.py"),
    ("rtvc_tpu_torch/tui.py", "rtvc_tpu/tui.py")])
def test_numpy_copies_equal_their_originals(copy, original):
    def body(path):  # the code after the docstring, the package's name taken out
        text = (REPO / path).read_text()
        return text[text.index('"""', 3) + 3:].replace("rtvc_tpu_torch.", "rtvc_tpu.")

    assert body(copy) == body(original)


@pytest.mark.parametrize("copy,original", [
    ("rtvc_tpu_torch/native/src/audio_codec.c", "rtvc_tpu/native/src/audio_codec.c"),
    ("rtvc_tpu_torch/native/src/wavernn_engine.cpp", "rtvc_tpu/native/src/wavernn_engine.cpp"),
    ("rtvc_tpu_torch/native/src/wavernn_engine.h", "rtvc_tpu/native/src/wavernn_engine.h"),
    ("rtvc_tpu_torch/native/src/vocoder_cli.cpp", "rtvc_tpu/native/src/vocoder_cli.cpp")])
def test_native_copies_equal_their_originals(copy, original):
    """The codec shim's and the WaveRNN engine's C and C++ sources, byte for
    byte but for the package's name."""
    got = (REPO / copy).read_bytes().replace(b"rtvc_tpu_torch/", b"rtvc_tpu/")
    assert got == (REPO / original).read_bytes()


@pytest.mark.parametrize("name", ["MAGIC", "VARIANT_IDS", "MODE_IDS", "_w", "write_vec",
                                  "_weight_payload", "write_dense", "write_sparse",
                                  "write_matrix", "fold_batchnorm"])
def test_native_format_helpers_equal_their_originals(name):
    """``native/convert.py``'s RTVCNAT1 format helpers: the original's
    source for each function, the same value for each constant."""
    from rtvc_tpu.native import convert as jconvert
    from rtvc_tpu_torch.native import convert as tconvert

    got, want = getattr(tconvert, name), getattr(jconvert, name)
    if callable(want):
        assert inspect.getsource(got) == inspect.getsource(want)
    else:
        assert got == want


def _code_lines(path, drop_from="", drop_to=""):
    """The code after the docstring without its import lines and blank
    lines, and without the lines from the one that starts with
    ``drop_from`` (stripped) through the one that starts with ``drop_to``."""
    text = (REPO / path).read_text()
    out, dropping = [], False
    for line in text[text.index('"""', 3) + 3:].splitlines():
        code = line.strip()
        if drop_from and code.startswith(drop_from):
            dropping = True
        if not dropping and code and not code.startswith(("import ", "from ")):
            out.append(line)
        if dropping and code.startswith(drop_to):
            dropping = False
    return out


def test_libwavernn_binding_equals_its_original():
    """``native/libwavernn.py`` is the JAX package's binding but for the
    imports, the ``jnp`` stand-in and the library's path: ``_load_lib``
    builds the port's engine instead of reading ``build.sh``'s output."""
    got = _code_lines("rtvc_tpu_torch/native/libwavernn.py", "class jnp:",
                      "lib = ctypes.CDLL(str(path))")
    want = _code_lines("rtvc_tpu/native/libwavernn.py", "_LIB_PATH =",
                       "lib = ctypes.CDLL(str(path))")
    assert got == want and len(want) > 200


def test_toolbox_page_equals_the_jax_page():
    from rtvc_tpu import webui as jwebui
    from rtvc_tpu_torch import webui as twebui

    assert twebui.PAGE == jwebui.PAGE and twebui.AUDIO_SUFFIXES == jwebui.AUDIO_SUFFIXES


def test_vocoder_dataset_copy_yields_the_same_batches(tmp_path):
    from test_torch_train import _make_vocoder_dataset

    root = _make_vocoder_dataset(tmp_path / "voc", n_utts=6)
    out = []
    for mod, cfg in ((jvoc, jcfg.wavernn_runtimeracer), (tvoc, tcfg.wavernn_runtimeracer)):
        cfg = cfg.replace(seq_len=400)
        ds = mod.VocoderDataset(root / "synthesized.json", root / "mels_gta", root / "wav", cfg)
        it = mod.batch_iterator(ds, 2, cfg, seed=3)
        out.append([b for _ in range(2) for b in it])
    assert len(out[0]) == len(out[1]) == 6
    for a, b in zip(*out):
        _batches_equal(a, b)


def test_ge2e_sampler_copy_yields_the_same_batches(tmp_path):
    from test_torch_train import _make_encoder_dataset

    root = _make_encoder_dataset(tmp_path / "enc", n_speakers=3, n_utts=4)
    out = []
    for mod in (jge2e, tge2e):
        random.seed(0)
        it = mod.speaker_batch_iterator(mod.SpeakerVerificationDataset(root), 2, 3, 160,
                                        prefetch=0, seed=11)
        out.append([next(it) for _ in range(3)])
    for a, b in zip(*out):
        assert a.shape == (6, 160, 40)
        np.testing.assert_array_equal(a, b)


def test_metrics_copy_logs_the_same(tmp_path, capsys):
    rows = []
    for mod, name in ((jmetrics, "j.tsv"), (tmetrics, "t.tsv")):
        log = mod.MetricsLogger(tmp_path / name)
        log.log(1, {"loss": 0.5, "lr": 1e-3})
        log.log(2, {"loss": 0.25})
        w = mod.ValueWindow(2)
        for v in (1.0, 2.0, 4.0):
            w.append(v)
        rows.append(([line.split("\t")[:3] for line in
                      (tmp_path / name).read_text().splitlines()], w.average, w.count))
    assert rows[0] == rows[1] and rows[1][1] == 3.0
    assert json.dumps(rows[1][0][1]) == json.dumps(["1", "loss", "0.5"])
