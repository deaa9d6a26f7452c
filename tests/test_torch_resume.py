"""The port's trainers take up runs of the JAX package's trainers (f32 on the
CPU, narrow widths): a tiny JAX run writes ``<run_id>.ckpt``, and the port's
``train_encoder``, ``train_synthesizer`` and ``train_vocoder`` in the same
run directory, without a ``<run_id>.pt``, continue it:

  * at the JAX run's step, and in the session, reduction factor and
    learning rate the JAX trainer gives that step;
  * with the parameters and running statistics equal in bits to
    ``read_model`` of the file, and Adam empty, as the JAX trainers start it
    on a resume (they do not read their ``opt_state`` back);
  * for the encoder and the WaveRNN, the first resumed step held against
    the JAX trainer's own resumed step on the same batch: the loss (and the
    encoder's gradient norm) within 1e-4 relative, as in
    ``test_torch_train``, and every weight after the step within 1.01 × lr
    of JAX's (Adam's first update is ±lr where a gradient is clear of ε);
  * the port saves ``<run_id>.pt`` from then on, which later resumes take;
    ``resume=False`` (``--force_restart``) ignores both files.

The JAX runs start from the port's seeded weights through the JAX
importers (the JAX initialisers take tens of seconds op by op here).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu.config.synthesizer import TacotronParams as JTacotronParams
from rtvc_tpu.config.vocoder import WaveRNNParams as JWaveRNNParams
from rtvc_tpu.models import factories as jfactories
from rtvc_tpu.models import speaker_encoder as jspk
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.train import trainer as jtrain
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.train import trainer as ttrain
from rtvc_tpu_torch.train.checkpoints import read_model
from test_torch_taco_train import SMALL as TACO_SMALL
from test_torch_taco_train import _epochs as taco_epochs
from test_torch_taco_train import _make_syn_dataset
from test_torch_train import SMALL as ENC_SMALL
from test_torch_train import _encoder_batches, _voc_cfg, _voc_epochs

VOC = "runtimeracer-wavernn"


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def taken_up(monkeypatch):
    """What ``_resume`` left: the step, a copy of the model's state and the
    optimizer's state, for each call."""
    seen = []
    resume = ttrain._resume

    def spy(cadence, model, optimizer, *args):
        step = resume(cadence, model, optimizer, *args)
        seen.append((step, {k: t.clone() for k, t in model.state_dict().items()},
                     optimizer.state_dict()))
        return step

    monkeypatch.setattr(ttrain, "_resume", spy)
    return seen


def _assert_taken_up(seen, path, kind, step):
    [(got_step, state, opt)] = seen
    want = read_model(path, kind)
    assert got_step == want.step == step
    assert state.keys() == want.state_dict.keys()
    for name, t in state.items():
        assert torch.equal(t, want.state_dict[name]), name
    assert opt["state"] == {}  # Adam starts afresh


def _close_after_one_adam_step(got_sd, want_sd, lr):
    for name, t in got_sd.items():
        assert float((t - want_sd[name]).abs().max()) <= 1.01 * lr, name


def _jax_copy(run_dir, dest):
    """A copy of the JAX run's directory, for JAX's own resume."""
    shutil.copytree(run_dir, dest)
    return dest


def test_encoder_takes_up_a_jax_run(tmp_path, taken_up):
    batches = _encoder_batches(3)
    lr = 1e-3
    kw = dict(speakers_per_batch=2, utterances_per_speaker=3, learning_rate=lr, eer_every=1)
    port_model = factories.init_encoder_model(seed=0, device="cpu", model_cfg=ENC_SMALL)
    jmodel = jspk.SpeakerEncoder(model=JEncoderModelParams(**ENC_SMALL.asdict()))
    jtrain.train_encoder("run", iter(batches[:2]), tmp_path / "port", total_steps=2,
                         model=jmodel, **kw)
    ckpt = tmp_path / "port" / "run" / "run.ckpt"
    assert ckpt.exists() and not ckpt.with_suffix(".pt").exists()
    _jax_copy(tmp_path / "port", tmp_path / "jax")
    want = jtrain.train_encoder("run", iter(batches[2:]), tmp_path / "jax", total_steps=3,
                                model=jmodel, **kw)
    got = ttrain.train_encoder("run", iter(batches[2:]), tmp_path / "port", total_steps=3,
                               model=port_model, device="cpu", **kw)
    _assert_taken_up(taken_up, ckpt, "encoder", 2)
    assert got["step"] == want["step"] == 3 and len(got["losses"]) == 1
    for key in ("loss", "grad_norm"):
        assert abs(got[key] / want[key] - 1) <= 1e-4, key
    _close_after_one_adam_step(got["model"].state_dict(),
                               read_model(tmp_path / "jax" / "run" / "run.ckpt",
                                          "encoder").state_dict, lr)
    # from here on the port's own file; a forced restart reads neither
    assert torch.load(tmp_path / "port" / "run" / "run.pt", weights_only=True)["step"] == 3
    fresh = ttrain.train_encoder("run", iter(batches[:1]), tmp_path / "port", total_steps=1,
                                 model=factories.init_encoder_model(seed=0, device="cpu",
                                                                    model_cfg=ENC_SMALL),
                                 resume=False, device="cpu", **kw)
    assert fresh["step"] == 1


def test_vocoder_takes_up_a_jax_run(tmp_path, monkeypatch, taken_up):
    cfg = _voc_cfg()  # one session of 3 steps, lr 1e-3 → 5e-4
    jcfg = JWaveRNNParams(**cfg.asdict())
    d = factories.wavernn_dims(VOC, cfg)
    model = factories.init_wavernn(d, seed=0, device="cpu")
    v = jw.import_torch_state({k: t.clone() for k, t in model.state_dict().items()},
                              jw.WaveRNNDims(**d._asdict()))
    init = jfactories.init_voc_model
    monkeypatch.setattr(jfactories, "init_voc_model",
                        lambda *a, **k: init(*a, **{**k, "variables": v}))
    epochs = _voc_epochs(cfg)
    jtrain.train_vocoder("run", VOC, tmp_path / "port", epochs, max_steps=2, override_hp=jcfg)
    ckpt = tmp_path / "port" / "run" / "run.ckpt"
    _jax_copy(tmp_path / "port", tmp_path / "jax")
    want = jtrain.train_vocoder("run", VOC, tmp_path / "jax", epochs, override_hp=jcfg)
    got = ttrain.train_vocoder("run", VOC, tmp_path / "port", epochs, override_hp=cfg,
                               device="cpu")
    _assert_taken_up(taken_up, ckpt, "vocoder", 2)
    assert got["step"] == want["step"] == 3 and len(got["losses"]) == 1
    assert abs(got["loss"] / want["loss"] - 1) <= 1e-4
    # the third step of the session's decay, in both trainers' metrics
    jlr = (tmp_path / "jax" / "run" / "metrics.tsv").read_text().splitlines()
    tlr = (tmp_path / "port" / "run" / "metrics.tsv").read_text().splitlines()
    lr = ttrain.linear_session_lr(1e-3, 5e-4, 2, 3)
    assert [r.split("\t")[:3] for r in jlr if r.startswith("3\tlr")] \
        == [r.split("\t")[:3] for r in tlr if r.startswith("3\tlr")] == [["3", "lr", f"{lr}"]]
    _close_after_one_adam_step(got["model"].state_dict(),
                               read_model(tmp_path / "jax" / "run" / "run.ckpt",
                                          "vocoder").state_dict, lr)


def test_synthesizer_takes_up_a_jax_run(tmp_path, monkeypatch, taken_up):
    # 6 utterances: session 1 is 3 steps at r 3, session 2 six at r 2; the
    # JAX run takes two
    root = _make_syn_dataset(tmp_path / "syn", 6)
    jcfg = JTacotronParams(**TACO_SMALL.asdict())
    b = factories.init_syn_model("tacotron", seed=0, override_hp=TACO_SMALL, device="cpu")
    v = jt.import_torch_state({k: t.clone() for k, t in b.model.state_dict().items()},
                              jt.TacotronDims(**b.dims._asdict()))
    g = np.random.default_rng(1)  # running statistics away from their initial values
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(g.uniform(0.5, 1.5, x.shape), jnp.float32), v["batch_stats"])
    init = jfactories.init_syn_model
    monkeypatch.setattr(jfactories, "init_syn_model",
                        lambda *a, **k: init(*a, **{**k, "variables": v}))
    epochs = taco_epochs(root)
    jtrain.train_synthesizer("run", "tacotron", root, tmp_path, epochs, max_steps=2,
                             override_hp=jcfg, save_every=0)
    ckpt = tmp_path / "run" / "run.ckpt"
    assert read_model(ckpt, "synthesizer").r == 3  # session 1's
    got = ttrain.train_synthesizer("run", "tacotron", tmp_path, epochs, max_steps=5,
                                   override_hp=TACO_SMALL, device="cpu")
    _assert_taken_up(taken_up, ckpt, "synthesizer", 2)
    # session 1's last step at r 3, then session 2's first two at r 2, each
    # at the learning rate the JAX trainer gives its step
    assert got["step"] == 5 and got["r"] == 2 and len(got["losses"]) == 3
    assert got["lrs"] == [jtrain.linear_session_lr(1e-3, 1e-4, 2, 3)] + [
        jtrain.linear_session_lr(5e-4, 1e-5, s, 6) for s in range(2)]
    assert np.isfinite(got["losses"]).all()
    state = torch.load(tmp_path / "run" / "run.pt", weights_only=True)
    assert state["step"] == 5 and state["extras"]["r"] == 2
    # the next resume reads the port's own file, with its Adam
    taken_up.clear()
    again = ttrain.train_synthesizer("run", "tacotron", tmp_path, epochs, max_steps=6,
                                     override_hp=TACO_SMALL, device="cpu")
    assert again["step"] == 6 and taken_up[0][0] == 5 and taken_up[0][2]["state"] != {}


def test_a_ckpt_that_no_reader_reads_raises(tmp_path):
    # a run directory's ``<run_id>.ckpt`` is read as ``read_model`` reads it:
    # a file of no format it knows stops the run instead of restarting it at
    # step 0
    cadence = ttrain.CheckpointCadence(tmp_path / "run", "run", "encoder")
    (tmp_path / "run" / "run.ckpt").write_bytes(b"not a checkpoint")
    model = factories.init_encoder_model(seed=0, device="cpu", model_cfg=ENC_SMALL)
    with pytest.raises(Exception):
        ttrain._resume(cadence, model, ttrain.make_optimizer(model.parameters()), "cpu",
                       "encoder", "encoder")
