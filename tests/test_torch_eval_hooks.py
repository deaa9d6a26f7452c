"""The trainers' checkpoint-time samples and evaluation hooks (f32 on the
CPU, narrow widths at the corpus's 80 mels, hop 200 and 768-d embeddings):

  * ``train.gen_testset.gen_testset`` against the JAX package's on the same
    weights and dataset: the same file names, ``target.wav`` equal in its
    bytes; the Griffin-Lim and WaveRNN wavs, whose noise comes from other
    generators (their functions are held to JAX's in ``test_torch_dsp`` and
    ``test_torch_wavernn``), of JAX's length and finite;
  * the Tacotron, ForwardTacotron, FastPitch and encoder-projection hooks'
    files with matplotlib, and without it (its import made to fail): the
    wavs and no plot, nothing raised;
  * a training step taken after ``gen_testset`` or a hook equals the step
    taken without it (``train_vocoder`` with its ``gen_hook``,
    ``train_synthesizer`` with its ``eval_hook``), and the model's mode and
    running statistics are as they were;
  * the entry points' wiring (``vocoder_train.sample_hook``, the
    synthesizer type's hook).
"""
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rtvc_tpu.config.vocoder import WaveRNNParams as JWaveRNNParams
from rtvc_tpu.data.vocoder_dataset import VocoderDataset as JVocoderDataset
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.train import gen_testset as jgen
from rtvc_tpu_torch import bridge, vocoder_train
from rtvc_tpu_torch.config.vocoder import WaveRNNParams
from rtvc_tpu_torch.data.vocoder_dataset import VocoderDataset, batch_iterator
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.train import eval_hooks
from rtvc_tpu_torch.train import trainer as ttrain
from rtvc_tpu_torch.train.gen_testset import gen_testset
from rtvc_tpu_torch.utils import plots
from test_torch_align import ALIGNER_CFG
from test_torch_gta import CFGS
from test_torch_taco_train import SMALL as TACO_SMALL
from test_torch_taco_train import _epochs as taco_epochs
from test_torch_taco_train import _make_syn_dataset
from test_torch_train import _make_vocoder_dataset

VOC = "runtimeracer-wavernn"
# a narrow runtimeracer at the dataset's widths; a short fold window keeps
# the CPU sample loop short
VOC_CFG = dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=16, res_blocks=1,
               seq_len=200, voc_tts_schedule=((1, 1e-3, 5e-4, 2),), gen_target=100,
               gen_overlap=25, gen_at_checkpoint=2)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib's import fails, as on a machine without it."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plots.available()


def _names(d):
    return sorted(p.name for p in d.iterdir())


def _read(path):
    sr, data = wavfile.read(path)
    assert sr == 16000 and data.dtype == np.int16
    return data


def test_gen_testset_matches_jax(tmp_path):
    root = _make_vocoder_dataset(tmp_path / "voc", n_utts=2, frames=8)
    cfg, jcfg = WaveRNNParams(**VOC_CFG), JWaveRNNParams(**VOC_CFG)
    d = factories.wavernn_dims(VOC, cfg)
    jd = jw.WaveRNNDims(**d._asdict())
    model = factories.init_wavernn(d, device="cpu")
    variables = jw.import_torch_state({k: t.clone() for k, t in model.state_dict().items()}, jd)
    assert all(torch.equal(t, model.state_dict()[k])
               for k, t in bridge.wavernn_state(variables).items())
    args = (root / "synthesized.json", root / "mels_gta", root / "wav")
    jgen.gen_testset(variables, jd, jcfg, JVocoderDataset(*args, jcfg), tmp_path / "jax", 7)
    gen_testset(model, d, cfg, VocoderDataset(*args, cfg), tmp_path / "port", 7)
    names = _names(tmp_path / "jax")
    assert names == _names(tmp_path / "port") == sorted(
        f"7_{i}_{k}" for i in range(2) for k in ("target.wav", "griffinlim.wav",
                                                 "generated.wav", "compare.png"))
    for i in range(2):
        got, want = (_read(tmp_path / s / f"7_{i}_target.wav") for s in ("port", "jax"))
        assert got.tobytes() == want.tobytes() and len(got) == 8 * 200
        for kind in ("griffinlim", "generated"):
            got, want = (_read(tmp_path / s / f"7_{i}_{kind}.wav") for s in ("port", "jax"))
            assert len(got) == len(want) and np.abs(got).max() > 0, kind


def test_gen_testset_without_matplotlib(tmp_path, no_matplotlib):
    root = _make_vocoder_dataset(tmp_path / "voc", n_utts=1, frames=12)
    cfg = WaveRNNParams(**VOC_CFG)
    d = factories.wavernn_dims(VOC, cfg)
    ds = VocoderDataset(root / "synthesized.json", root / "mels_gta", root / "wav", cfg)
    gen_testset(factories.init_wavernn(d, device="cpu"), d, cfg, ds, tmp_path / "s", 3,
                samples=5)
    assert _names(tmp_path / "s") == ["3_0_generated.wav", "3_0_griffinlim.wav",
                                      "3_0_target.wav"]


HOOKS = {
    "tacotron": (lambda out: eval_hooks.make_tacotron_eval_hook(out, max_steps=12),
                 ["attention_5.png", "eval_5.wav", "mel_5.png"]),
    "forward-tacotron": (lambda out: eval_hooks.make_nar_eval_hook(out, "forward-tacotron"),
                         ["energy_sweep_5.png", "eval_5.wav", "mel_5.png",
                          "pitch_sweep_5.png"]),
    "fast-pitch": (lambda out: eval_hooks.make_nar_eval_hook(out, "fast-pitch"),
                   ["energy_sweep_5.png", "eval_5.wav", "mel_5.png", "pitch_sweep_5.png"]),
}


def _run_hook(tmp_path, model_type):
    make, files = HOOKS[model_type]
    model = factories.init_syn_model(model_type, override_hp=ALIGNER_CFG if model_type ==
                                     "tacotron" else CFGS[model_type], device="cpu").model
    model.train()
    state = {k: t.clone() for k, t in model.state_dict().items()}
    make(tmp_path / "samples")(5, model, 2)
    assert model.training
    assert all(torch.equal(t, state[k]) for k, t in model.state_dict().items())
    wav = _read(tmp_path / "samples" / "eval_5.wav")
    assert len(wav) > 0 and np.abs(wav).max() > 0
    return files


@pytest.mark.parametrize("model_type", sorted(HOOKS))
def test_synthesizer_hooks_write_their_files(tmp_path, model_type):
    files = _run_hook(tmp_path, model_type)
    assert _names(tmp_path / "samples") == files


@pytest.mark.parametrize("model_type", sorted(HOOKS))
def test_synthesizer_hooks_without_matplotlib(tmp_path, no_matplotlib, model_type):
    _run_hook(tmp_path, model_type)
    assert _names(tmp_path / "samples") == ["eval_5.wav"]


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_encoder_projection_hook(tmp_path, monkeypatch, with_matplotlib):
    if not with_matplotlib:
        monkeypatch.setattr(plots, "_plt", lambda: None)
    rng = np.random.default_rng(0)
    embeds = (np.repeat(rng.standard_normal((3, 16)), 4, axis=0)
              + 0.1 * rng.standard_normal((12, 16))).astype(np.float32)
    eval_hooks.make_encoder_projection_hook(tmp_path / "p", 3)(4, embeds)
    assert (tmp_path / "p" / "projection_4.png").exists() == with_matplotlib


def test_vocoder_step_after_gen_testset_is_unchanged(tmp_path):
    root = _make_vocoder_dataset(tmp_path / "voc", n_utts=2, frames=12)
    cfg = WaveRNNParams(**VOC_CFG)
    ds = VocoderDataset(root / "synthesized.json", root / "mels_gta", root / "wav", cfg)
    hook = vocoder_train.sample_hook(VOC, cfg, ds, tmp_path / "samples")
    batch = next(iter(batch_iterator(ds, 2, cfg, seed=0)))

    def epochs(session_idx):
        return [batch] * 3

    kw = dict(override_hp=cfg, device="cpu", save_every=0)
    plain = ttrain.train_vocoder("a", VOC, tmp_path, epochs, **kw)
    hooked = ttrain.train_vocoder("b", VOC, tmp_path, epochs, gen_hook=hook, gen_every=1, **kw)
    assert hooked["losses"] == plain["losses"] and len(plain["losses"]) == 3
    for (name, a), b in zip(plain["model"].state_dict().items(),
                            hooked["model"].state_dict().values()):
        assert torch.equal(a, b), name
    # three checkpoints' samples, the config's two items each
    assert len(list((tmp_path / "samples").glob("*_generated.wav"))) == 3 * 2


@pytest.mark.parametrize("model_type", ["tacotron", "forward-tacotron"])
def test_synthesizer_step_after_eval_hook_is_unchanged(tmp_path, model_type):
    if model_type == "tacotron":
        root, cfg = _make_syn_dataset(tmp_path / "syn", 4), TACO_SMALL
        epochs = taco_epochs(root)
    else:
        from test_torch_align import aligned_root
        from test_torch_nar_train import SMALL, _epochs

        root = aligned_root(tmp_path / "syn", 4)
        cfg = SMALL[model_type].replace(**{k: v for k, v in CFGS[model_type].asdict().items()
                                           if k.endswith("dropout")})
        epochs = _epochs(root, model_type)
    # the entry point's hook, the Tacotron's decode cut short for the CPU
    hook = eval_hooks.make_tacotron_eval_hook(tmp_path / "samples", max_steps=12) \
        if model_type == "tacotron" else \
        eval_hooks.make_synthesizer_eval_hook(tmp_path / "samples", model_type)
    kw = dict(override_hp=cfg, device="cpu", save_every=0, max_steps=3)
    plain = ttrain.train_synthesizer("a", model_type, tmp_path, epochs, **kw)
    hooked = ttrain.train_synthesizer("b", model_type, tmp_path, epochs, eval_hook=hook,
                                      eval_interval=1, **kw)
    assert hooked["losses"] == plain["losses"] and len(plain["losses"]) == 3
    for (name, a), b in zip(plain["model"].state_dict().items(),
                            hooked["model"].state_dict().values()):
        assert torch.equal(a, b), name
    assert sorted(p.name for p in (tmp_path / "samples").glob("*.wav")) == \
        ["eval_1.wav", "eval_2.wav", "eval_3.wav"]
