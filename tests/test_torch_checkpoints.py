"""Checkpoints into the port's inference modules, at the narrow widths of
``test_torch_clone.py``. The port reads the three formats users hold, told
apart by content:

* the JAX package's ``.ckpt``, written here by ``rtvc_tpu.train.checkpoints.
  save_checkpoint`` in the JAX trainers' layouts: the port's state_dict
  equals ``bridge.*_state`` of what ``rtvc_tpu``'s own loader gives, bit
  for bit, with the same step, model type, r and config;
* the reference's torch ``.pt``, with its extra buffers: both packages read
  it to the same weights, and their Tacotron mels agree with prenet dropout
  off (1e-4, as in ``test_torch_clone.py``);
* the port's own trainer file: a vocoder loaded from it vocodes exactly as
  the trained module does.

ForwardTacotron and FastPitch load from all three (at the narrow widths of
their own test files), bit for bit.

The port's msgpack reader is held to ``flax.serialization.msgpack_restore``
on the same bytes."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import rtvc_tpu.config.synthesizer as jsyn_cfg
import rtvc_tpu.config.vocoder as jvoc_cfg
import rtvc_tpu_torch.config.synthesizer as tsyn_cfg
import rtvc_tpu_torch.config.vocoder as tvoc_cfg
from rtvc_tpu.config.encoder import EncoderDataParams as JEncoderDataParams
from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu.config.synthesizer import FastPitchParams as JFastPitchParams
from rtvc_tpu.config.synthesizer import ForwardTacotronParams as JForwardTacotronParams
from rtvc_tpu.config.synthesizer import TacotronParams as JTacotronParams
from rtvc_tpu.config.vocoder import WaveRNNParams as JWaveRNNParams
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu.inference import synthesizer as jsyn
from rtvc_tpu.inference import vocoder as jvoc
from rtvc_tpu.models import factories as jfactories
from rtvc_tpu.models.speaker_encoder import SpeakerEncoder as JSpeakerEncoder
from rtvc_tpu.models import fast_pitch as jfp
from rtvc_tpu.models import forward_tacotron as jft
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from rtvc_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.train import checkpoints as tckpt
from rtvc_tpu_torch.train import trainer as ttrain
from rtvc_tpu_torch.utils import flax_msgpack
from test_torch_clone import ENC, SYN, TEXT, VOC, _jax_synthesize
from test_torch_fast_pitch import CFG as FP_CFG
from test_torch_forward_tacotron import CFG as FT_CFG
from test_torch_train import _voc_cfg, _voc_epochs


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread: these CPU models are small, and beside the other
    test workers more OpenMP threads only wait on each other (a 6 s test
    took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_singletons(monkeypatch):
    """Every loader below installs module-level state in both packages."""
    for mod, names in ((jenc, ("_model", "_params", "_model_cfg", "_data")),
                       (jvoc, ("_model", "_model_type", "_seed", "_gen_counter")),
                       (tenc, ("_model", "_model_cfg", "_data")),
                       (tsyn, ("_model",)),
                       (tvoc, ("_bundle", "_seed", "_gen_counter"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))


def _assert_state_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name].cpu(), t), name


def _perturbed(tree, seed):
    """Running statistics away from their initial values, so that a loader
    that dropped them would show."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


# -- the msgpack reader -------------------------------------------------------

TREES = {
    "nested": {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
                     "c": {"d": np.int32(-4), "e": np.zeros((0, 3), np.int8)}},
               "f": np.ones((3, 70), np.float64)},
    "lists": {"layers": [np.full(4, i, np.float32) for i in range(3)],
              "ints": [0, 127, 128, -1, -33, 255, 65536, -40000, 2 ** 40, -2 ** 40],
              "mixed": [1.5, "x" * 40, b"\x00\xff", None, True, False, "é"]},
    "npscalar": {"count": np.int64(7), "scale": np.float32(0.25), "flag": np.bool_(True)},
    "bf16": {"w": np.asarray(jnp.linspace(-2, 2, 12, dtype=jnp.bfloat16).reshape(3, 4)),
             "s": jnp.bfloat16(1.5)},
    "empty_opt_state": {"meta": "{}", "params": {"w": np.ones(2, np.float32)},
                        "opt_state": {}, "extras": {}},
    "optax_adam": serialization.to_state_dict(
        optax.adam(1e-3).init({"w": jnp.ones((2, 3)), "b": jnp.zeros(3)})),
}


def _assert_tree_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(got, torch.Tensor):  # a bfloat16 leaf
        assert got.dtype == torch.bfloat16 and str(np.asarray(want).dtype) == "bfloat16", path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", list(TREES))
def test_msgpack_reader_matches_flax(name):
    blob = serialization.msgpack_serialize(TREES[name])
    _assert_tree_equal(flax_msgpack.restore(blob), serialization.msgpack_restore(blob))


def test_msgpack_reader_refuses_chunked_arrays_and_trailing_bytes():
    chunked = {"w": serialization._chunk(np.arange(10, dtype=np.float32))}
    with pytest.raises(ValueError, match="chunk"):
        flax_msgpack.restore(serialization.msgpack_serialize(chunked))
    with pytest.raises(ValueError, match="after the object"):
        flax_msgpack.restore(serialization.msgpack_serialize({"a": 1}) + b"\xc0")


# -- JAX .ckpt files ----------------------------------------------------------


def test_jax_encoder_ckpt_loads_bit_for_bit(tmp_path):
    jmodel_cfg, jdata_cfg = JEncoderModelParams(**ENC.asdict()), JEncoderDataParams()
    model = JSpeakerEncoder(model=jmodel_cfg, data=jdata_cfg)
    params = {"model": model.init(jax.random.PRNGKey(3), jnp.zeros((1, 160, 40)))["params"],
              "similarity": {"similarity_weight": jnp.asarray([7.5]),
                             "similarity_bias": jnp.asarray([-2.25])}}
    # named .pt on purpose: the format is read from the content
    path = tmp_path / "encoder.pt"
    jax_save_checkpoint(path, params, 17, "speaker_encoder", optax.adam(1e-4).init(params),
                        extras={"config": {"model": jmodel_cfg.asdict(),
                                           "data": jdata_cfg.asdict()}})
    jenc.load_model(path)
    tenc.load_model(path, device="cpu")

    ckpt = tckpt.read_model(path, "encoder")
    assert (ckpt.step, ckpt.model_type, ckpt.r) == (17, "speaker_encoder", None)
    assert tenc._model_cfg.asdict() == jenc._model_cfg.asdict() == ENC.asdict()
    assert tenc._data.asdict() == jenc._data.asdict()
    # the JAX loader keeps the model tree only; the port also keeps the GE2E
    # scale, which is part of its SpeakerEncoder
    want = bridge.speaker_encoder_state({**jenc._params,
                                         "similarity": params["similarity"]})
    _assert_state_equal(tenc._model.state_dict(), want)
    assert float(want["similarity_weight"][0]) == 7.5


def test_jax_tacotron_ckpt_loads_bit_for_bit(tmp_path):
    jcfg = JTacotronParams(**SYN.asdict())
    # JAX variables of seeded weights (the JAX package's own initialiser is
    # slow op by op on the CPU)
    syn = factories.init_syn_model("tacotron", seed=4, override_hp=SYN, device="cpu")
    variables = jt.import_torch_state(syn.model.state_dict(),
                                      jt.TacotronDims(**syn.dims._asdict()))
    stats = _perturbed(variables["batch_stats"], 5)
    path = tmp_path / "synthesizer.ckpt"
    jax_save_checkpoint(path, variables["params"], 250, "tacotron", {},
                        extras={"batch_stats": stats, "r": 3, "config": jcfg.asdict()})
    jsynth = jsyn.Synthesizer(path, verbose=False)
    jsynth.load()
    tsyn.load_model(path, verbose=False, device="cpu")
    synth = tsyn._model

    assert tsyn.is_loaded() and tsyn.get_model_type() == jsynth.get_model_type() == "tacotron"
    assert synth._r == jsynth._r == 3 and synth._step == 250
    assert synth._bundle.config == SYN and synth._bundle.config.asdict() == jcfg.asdict()
    assert isinstance(synth._bundle.config.tts_schedule[0], tuple)
    _assert_state_equal(synth._bundle.model.state_dict(),
                        bridge.tacotron_state(jsynth._model.variables))


@pytest.mark.parametrize("model_type", factories.VOC_MODEL_TYPES)
def test_jax_wavernn_ckpt_loads_bit_for_bit(tmp_path, model_type):
    defaults = {"fatchord-wavernn": jvoc_cfg.wavernn_fatchord,
                "geneing-wavernn": jvoc_cfg.wavernn_geneing,
                "runtimeracer-wavernn": jvoc_cfg.wavernn_runtimeracer}
    jcfg = defaults[model_type].replace(rnn_dims=32, fc_dims=32, compute_dims=16,
                                        res_out_dims=32, res_blocks=2)
    bundle = jfactories.init_voc_model(model_type, seed=6, override_hp=jcfg)
    stats = _perturbed(bundle.variables["batch_stats"], 7)
    path = tmp_path / "vocoder.ckpt"
    jax_save_checkpoint(path, bundle.variables["params"], 33, model_type,
                        optax.adam(1e-4).init(bundle.variables["params"]),
                        extras={"batch_stats": stats, "config": jcfg.asdict()})
    jvoc.load_model(path, verbose=False)
    tvoc.load_model(path, verbose=False, device="cpu")

    ckpt = tckpt.read_model(path, "vocoder")
    assert (ckpt.step, ckpt.model_type) == (33, model_type)
    assert tvoc._bundle.model_type == model_type
    assert tvoc._bundle.config.asdict() == jvoc._model.config.asdict() == jcfg.asdict()
    _assert_state_equal(tvoc._bundle.model.state_dict(),
                        bridge.wavernn_state(jvoc._model.variables))


def test_non_autoregressive_ckpt_is_a_later_slice(tmp_path):
    """The NAR synthesizers load and serve; their training is what is
    still a later slice. A NAR .ckpt without the model's weights names
    what is missing."""
    path = tmp_path / "fp.ckpt"
    jax_save_checkpoint(path, {"w": np.ones(2, np.float32)}, 1, "fast-pitch")
    with pytest.raises(KeyError, match="dur_pred"):
        tsyn.Synthesizer(path, device="cpu").load()
    assert factories.config_from_dict("forward-tacotron", {"embed_dims": 8}) == \
        tsyn_cfg.forward_tacotron.replace(embed_dims=8)
    with pytest.raises(NotImplementedError, match="later slice"):
        factories.get_model_train_elements("forward-tacotron")


NAR = {"forward-tacotron": (FT_CFG, JForwardTacotronParams, jft.ForwardTacotronDims,
                            jft.import_torch_state, bridge.forward_tacotron_state),
       "fast-pitch": (FP_CFG, JFastPitchParams, jfp.FastPitchDims, jfp.import_torch_state,
                      bridge.fast_pitch_state)}


@pytest.mark.parametrize("model_type", list(NAR))
def test_jax_nar_ckpt_loads_bit_for_bit(tmp_path, model_type):
    """A ForwardTacotron or FastPitch .ckpt in the JAX trainers' layout
    (the running statistics in the extras): the port's state equals the
    bridge of what the JAX package's own loader gives."""
    narrow, jparams, jdims, importer, to_state = NAR[model_type]
    tcfg = factories.default_config(model_type).replace(**narrow)
    jcfg = jparams(**tcfg.asdict())
    syn = factories.init_syn_model(model_type, seed=4, override_hp=tcfg, device="cpu")
    variables = importer({k: v.clone() for k, v in syn.model.state_dict().items()},
                         jdims(**syn.dims._asdict()))
    extras = {"config": jcfg.asdict()}
    if variables["batch_stats"]:
        extras["batch_stats"] = _perturbed(variables["batch_stats"], 5)
    path = tmp_path / "synthesizer.ckpt"
    jax_save_checkpoint(path, variables["params"], 120, model_type, {}, extras=extras)
    jsynth = jsyn.Synthesizer(path, verbose=False)
    jsynth.load()
    tsyn.load_model(path, verbose=False, device="cpu")
    synth = tsyn._model
    assert tsyn.get_model_type() == jsynth.get_model_type() == model_type
    assert synth._step == 120 and synth._bundle.config == tcfg
    assert synth._bundle.config.asdict() == jcfg.asdict()
    _assert_state_equal(synth._bundle.model.state_dict(), to_state(jsynth._model.variables))


# -- reference .pt files ------------------------------------------------------


def _reference_pt(path, model, model_type, **buffers):
    """A reference-layout torch file: ``model_state`` with the buffers the
    port's modules do not have (BatchNorm batch counters, step, r)."""
    state = dict(model.state_dict())
    for name in [n for n in state if n.endswith(".running_mean")]:
        state[name.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(12)
    state.update(buffers)
    torch.save({"step": 9, "model_state": state, "optimizer_state": {},
                "model_type": model_type}, path)
    return state


def test_reference_pt_loads_alike_in_both_packages(tmp_path, monkeypatch):
    # a reference .pt carries no config: both packages build at their
    # default widths, narrowed here to the test's
    monkeypatch.setattr(tsyn_cfg, "tacotron", SYN)
    monkeypatch.setattr(jsyn_cfg, "tacotron", JTacotronParams(**SYN.asdict()))
    monkeypatch.setattr(tvoc_cfg, "wavernn_runtimeracer", VOC)
    monkeypatch.setattr(jvoc_cfg, "wavernn_runtimeracer", JWaveRNNParams(**VOC.asdict()))
    syn = factories.init_syn_model("tacotron", seed=8, device="cpu")
    voc = factories.init_voc_model("runtimeracer-wavernn", seed=9, device="cpu")
    syn_state = _reference_pt(tmp_path / "syn.pt", syn.model, "tacotron",
                              **{"decoder.r": torch.tensor(2, dtype=torch.int32),
                                 "step": torch.zeros(1, dtype=torch.long)})
    _reference_pt(tmp_path / "voc.pt", voc.model, "runtimeracer-wavernn",
                  step=torch.zeros(1, dtype=torch.long))
    assert "decoder.r" in syn_state and "postnet.conv_project1.bnorm.num_batches_tracked" \
        in syn_state

    synth = tsyn.Synthesizer(tmp_path / "syn.pt", verbose=False, device="cpu")
    synth.load()
    assert synth._r == 2 and synth._step == 9
    _assert_state_equal(synth._bundle.model.state_dict(), syn.model.state_dict())
    tvoc.load_model(tmp_path / "voc.pt", verbose=False, device="cpu")
    _assert_state_equal(tvoc._bundle.model.state_dict(), voc.model.state_dict())
    # the JAX package's loaders read the same files: its checkpoint reader,
    # then its importers (its Synthesizer.load and vocoder.load_model also
    # draw random weights first, which is slow op by op on the CPU)
    jsyn_ckpt = jax_load_checkpoint(tmp_path / "syn.pt")
    assert int(jsyn_ckpt["torch_state"]["decoder.r"]) == 2
    jd_syn = jt.TacotronDims(**syn.dims._asdict())
    v_syn = jt.import_torch_state(jsyn_ckpt["torch_state"], jd_syn)
    _assert_state_equal(synth._bundle.model.state_dict(), bridge.tacotron_state(v_syn))
    v_voc = jw.import_torch_state(jax_load_checkpoint(tmp_path / "voc.pt")["torch_state"],
                                  jw.WaveRNNDims(**voc.dims._asdict()))
    _assert_state_equal(tvoc._bundle.model.state_dict(), bridge.wavernn_state(v_voc))

    embed = np.random.default_rng(10).standard_normal(768).astype(np.float32)
    embed /= np.linalg.norm(embed)
    [mel_t] = synth.synthesize_spectrograms([TEXT], [embed], prenet_dropout=False)
    mel_j = _jax_synthesize(v_syn, jd_syn, embed)
    assert mel_t.shape == mel_j.shape and mel_t.shape[0] == 80
    np.testing.assert_allclose(mel_t, mel_j, atol=1e-4)


def test_reference_forward_tacotron_pt_loads_bit_for_bit(tmp_path, monkeypatch):
    """A reference ForwardTacotron .pt (model_type named, a step buffer and
    BatchNorm's batch counters) loads strict at the default widths, narrowed
    here; the JAX package's reader and importer give the same weights."""
    monkeypatch.setattr(tsyn_cfg, "forward_tacotron", tsyn_cfg.forward_tacotron.replace(**FT_CFG))
    syn = factories.init_syn_model("forward-tacotron", seed=8, device="cpu")
    state = _reference_pt(tmp_path / "ft.pt", syn.model, "forward-tacotron",
                          step=torch.zeros(1, dtype=torch.long))
    assert "prenet.conv_project1.bnorm.num_batches_tracked" in state
    synth = tsyn.Synthesizer(tmp_path / "ft.pt", verbose=False, device="cpu")
    synth.load()
    assert synth.get_model_type() == "forward-tacotron" and synth._step == 9
    _assert_state_equal(synth._bundle.model.state_dict(), syn.model.state_dict())
    v = jft.import_torch_state(jax_load_checkpoint(tmp_path / "ft.pt")["torch_state"],
                               jft.ForwardTacotronDims(**syn.dims._asdict()))
    _assert_state_equal(synth._bundle.model.state_dict(), bridge.forward_tacotron_state(v))


def test_port_trainer_file_of_a_fast_pitch_loads_bit_for_bit(tmp_path, monkeypatch):
    cfg = tsyn_cfg.fast_pitch.replace(**FP_CFG)
    syn = factories.init_syn_model("fast-pitch", seed=2, override_hp=cfg, device="cpu")
    path = tmp_path / "fp.pt"
    tckpt.save_checkpoint(path, syn.model, 40, "fast-pitch", extras={"config": cfg.asdict()})
    tsyn.load_model(path, verbose=False, device="cpu")
    assert tsyn.get_model_type() == "fast-pitch" and tsyn._model._bundle.config == cfg
    _assert_state_equal(tsyn._model._bundle.model.state_dict(), syn.model.state_dict())
    # a FastPitch state without the speaker projections (the reference's
    # FastPitch has none, nor a config) takes them at zero, as the JAX
    # importer does
    monkeypatch.setattr(tsyn_cfg, "fast_pitch", cfg)
    state = {k: v for k, v in syn.model.state_dict().items() if "spk_proj." not in k}
    torch.save({"step": 3, "model_state": state, "model_type": "fast-pitch"}, tmp_path / "r.pt")
    model = factories.from_checkpoint(tckpt.read_model(tmp_path / "r.pt", "synthesizer"),
                                      "synthesizer", "cpu").model
    for k, v in model.state_dict().items():
        assert torch.equal(v, torch.zeros_like(v) if "spk_proj." in k else state[k]), k


# -- the port's own trainer file ----------------------------------------------


def test_port_trainer_file_vocodes_as_the_trained_module(tmp_path):
    cfg = _voc_cfg()
    out = ttrain.train_vocoder("v", "runtimeracer-wavernn", tmp_path, _voc_epochs(cfg),
                               max_steps=2, override_hp=cfg, device="cpu")
    assert out["step"] == 2
    mel = np.random.default_rng(11).uniform(-4, 0, (80, 7)).astype(np.float32)
    trained = out["model"].eval()
    tvoc.load_bundle(factories.VocModel("runtimeracer-wavernn",
                                        factories.wavernn_dims("runtimeracer-wavernn", cfg),
                                        trained, cfg))
    tvoc.set_seed(3)
    # a short fold window keeps the sample loop's steps few on the CPU
    want = tvoc.infer_waveform(mel, target=100, overlap=25)

    # named .ckpt on purpose: the format is read from the content
    path = tmp_path / "voc.ckpt"
    (tmp_path / "v" / "v.pt").rename(path)
    tvoc.load_model(path, verbose=False, device="cpu")
    assert tvoc._bundle.config == cfg and tvoc._bundle.model is not trained
    _assert_state_equal(tvoc._bundle.model.state_dict(), trained.state_dict())
    tvoc.set_seed(3)
    got = tvoc.infer_waveform(mel, target=100, overlap=25)
    assert got.shape == (6 * 200,) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert tckpt.read_model(path, "vocoder").step == 2


def test_unknown_contents_raise(tmp_path):
    torch.save([1, 2, 3], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="none of the checkpoint formats"):
        tckpt.read_model(tmp_path / "list.pt", "vocoder")
    with pytest.raises(ValueError, match="kind"):
        tckpt.read_model(tmp_path / "list.pt", "tacotron")
