"""The port's non-autoregressive synthesizer training against the JAX
package, at narrow widths with dropout 0 in the dims and zoneout 0 (f32 on
the CPU: K3 and K4 run their plain versions, the JAX package its scans):

  * ``forward_tacotron_forward`` and ``fastpitch_forward`` in train mode on
    shared weights (the port's seeded models, carried to JAX by its
    importers and back by ``bridge``): the five outputs and the new
    BatchNorm statistics within 2e-5;
  * one step of ``make_nar_synth_train_step`` against the JAX step: the loss
    within 1e-5 relative, every gradient within 1e-4 of its own largest
    entry (the convs ahead of a BatchNorm within 1e-4 of the model's
    largest), and the weights after one Adam step;
  * the gradient of the packed BiLSTM's input: zero on pad frames;
  * ``masked_l1_lastdim`` against the JAX loss;
  * ``train_synthesizer`` for both types on a tiny root written by the
    alignment pass (the steps, a falling loss, a mid-session resume), the
    session batch size of ``synthesizer_train``, and ``python -m
    rtvc_tpu_torch.synthesizer_train <run> forward-tacotron <root> --device
    cpu --max_steps 2`` at these widths.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvc_tpu.config.synthesizer import FastPitchParams as JFPParams
from rtvc_tpu.config.synthesizer import ForwardTacotronParams as JFTParams
from rtvc_tpu.models import fast_pitch as jfp
from rtvc_tpu.models import forward_tacotron as jft
from rtvc_tpu.train import steps as jsteps
from rtvc_tpu_torch import bridge, synthesizer_train
from rtvc_tpu_torch.config.synthesizer import FastPitchParams, ForwardTacotronParams
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import fast_pitch as tfp
from rtvc_tpu_torch.models import forward_tacotron as tft
from rtvc_tpu_torch.train import steps as tsteps
from rtvc_tpu_torch.train import trainer as ttrain
from test_torch_fast_pitch import _jax_variables
from test_torch_forward_tacotron import _copy
from test_torch_taco_train import recorded

REPO = Path(__file__).resolve().parents[1]
N_CHARS, N_MELS, SPK = 20, 6, 8
B, T_TEXT, FRAMES = 3, 16, 24
FT_CFG = dict(embed_dims=16, series_embed_dims=8, duration_conv_dims=12, duration_rnn_dims=8,
              pitch_conv_dims=12, pitch_rnn_dims=8, energy_conv_dims=12, energy_rnn_dims=8,
              prenet_dims=16, prenet_k=3, prenet_num_highways=2, rnn_dims=16, postnet_dims=12,
              postnet_k=3, postnet_num_highways=2, duration_dropout=0.0, pitch_dropout=0.0,
              energy_dropout=0.0, prenet_dropout=0.0, postnet_dropout=0.0)
FP_CFG = dict(embed_dims=16, n_heads=2, conv_dims=24, n_layers_enc=2, n_layers_dec=2,
              series_d_model=8, series_n_heads=2, series_layers=1, series_d_fft=12, dropout=0.0,
              series_dropout=0.0)
TYPES = ("forward-tacotron", "fast-pitch")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(model_type, seed=0):
    """The port's seeded narrow model (running statistics moved away from
    their initial values, so that a wrong momentum or a missed update
    shows), JAX dims, config and variables through the JAX package's
    importer (``bridge`` maps them back, bit for bit), and a seeded batch
    shaped as the trainer feeds it: durations summing to each row's frames,
    pitch and energy."""
    rng = np.random.default_rng(seed)
    if model_type == "forward-tacotron":
        jcfg, tcfg = JFTParams(**FT_CFG), ForwardTacotronParams(**FT_CFG)
        jd = jft.ForwardTacotronDims.from_config(jcfg, N_CHARS, N_MELS, SPK)
        d = tft.ForwardTacotronDims.from_config(tcfg, N_CHARS, N_MELS, SPK)
        model = factories.init_forward_tacotron(d, seed=seed, device="cpu")
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape) if name.endswith(
                    "var") else rng.normal(0, 0.2, buf.shape)).float())
        v = jft.import_torch_state(_copy(model.state_dict()), jd)
    else:
        jcfg, tcfg = JFPParams(**FP_CFG), FastPitchParams(**FP_CFG)
        jd = jfp.FastPitchDims.from_config(jcfg, N_CHARS, N_MELS, SPK)
        d = tfp.FastPitchDims.from_config(tcfg, N_CHARS, N_MELS, SPK)
        model = factories.init_fast_pitch(d, seed=seed, device="cpu")
        v = _jax_variables(model, jd)
    assert tuple(d) == tuple(jd)
    sd = model.state_dict()
    assert all(torch.equal(t, sd[k]) for k, t in _state_of(model_type, v).items())
    x_lens = np.array([16, 12, 9])
    spec_lens = np.array([FRAMES - 1, 17, 11])
    chars = np.where(np.arange(T_TEXT)[None, :] < x_lens[:, None],
                     rng.integers(1, N_CHARS, (B, T_TEXT)), 0).astype(np.int32)
    durations = np.zeros((B, T_TEXT), np.float32)
    for b in range(B):  # spec_lens[b] frames over the row's characters
        cuts = np.sort(rng.integers(0, spec_lens[b] + 1, x_lens[b] - 1))
        durations[b, :x_lens[b]] = np.diff(np.concatenate([[0], cuts, [spec_lens[b]]]))
    batch = {"chars": chars,
             "mels": rng.uniform(-4, 0, (B, N_MELS, FRAMES)).astype(np.float32),
             "embeds": rng.standard_normal((B, SPK)).astype(np.float32),
             "durations": durations, "spec_lens": spec_lens.astype(np.int32),
             "x_lens": x_lens.astype(np.int32),
             "pitch": np.where(durations > 0, rng.uniform(0, 2, (B, T_TEXT)), 0).astype(
                 np.float32),
             "energy": np.where(durations > 0, rng.uniform(0, 2, (B, T_TEXT)), 0).astype(
                 np.float32)}
    return jd, jcfg, tcfg, v, model, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(a).long() if a.dtype.kind == "i" else torch.from_numpy(a)
            for k, a in batch.items()}


def _state_of(model_type, variables):
    return (bridge.forward_tacotron_state if model_type == "forward-tacotron"
            else bridge.fast_pitch_state)(variables)


@pytest.mark.parametrize("model_type", TYPES)
def test_training_forward_matches_jax(model_type):
    jd, _, _, v, model, batch = _setup(model_type)
    jfwd = jax.jit(jft.forward_tacotron_forward if model_type == "forward-tacotron"
                   else jfp.fastpitch_forward, static_argnums=(1,), static_argnames=("train",))
    tfwd = tft.forward_tacotron_forward if model_type == "forward-tacotron" \
        else tfp.fastpitch_forward
    j = {k: jnp.asarray(a) for k, a in batch.items()}
    want = jfwd(v, jd, j["chars"], j["mels"], j["durations"], j["embeds"], j["spec_lens"],
                j["pitch"], j["energy"], jax.random.PRNGKey(1), train=True)
    b = _torch_batch(batch)
    buffers = {k: t.clone() for k, t in model.named_buffers()}
    with torch.no_grad():
        got = tfwd(model.train(), b["chars"], b["mels"], b["durations"], b["embeds"],
                   b["spec_lens"], b["pitch"], b["energy"], torch.Generator().manual_seed(1))
    for name, a, w in zip(("mel", "mel_post", "dur", "pitch", "energy"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
    if model_type == "fast-pitch":
        assert got[5] == {} and want[5] == {}
        return
    new = bridge.forward_tacotron_state({"params": v["params"], "batch_stats": want[5]})
    assert set(got[5]) == set(buffers)
    for name, value in got[5].items():
        np.testing.assert_allclose(value.numpy(), new[name].numpy(), atol=2e-5, err_msg=name)
        assert torch.equal(dict(model.named_buffers())[name], buffers[name])  # not written


@pytest.mark.parametrize("model_type", TYPES)
def test_nar_step_matches_jax(model_type):
    jd, jcfg, tcfg, v, model, batch = _setup(model_type, seed=1)
    lr = 1e-3
    opt = recorded(optax.adam(lr))
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731 (the step donates)
    params, new_stats, opt_state, stats = jsteps.make_nar_synth_train_step(
        model_type, jd, opt, jcfg)(copy(v["params"]), copy(v.get("batch_stats", {})),
                                   opt.init(v["params"]),
                                   {k: jnp.asarray(a) for k, a in batch.items()},
                                   jax.random.PRNGKey(2))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = tsteps.make_nar_synth_train_step(model_type, model.train(),
                                            ttrain.make_optimizer(model.parameters(), lr), tcfg)
    got = step(_torch_batch(batch), torch.Generator().manual_seed(2))
    assert abs(float(got["loss"]) / float(stats["loss"]) - 1) <= 1e-5
    for key in ("grad_norm", "m1", "m2", "dur", "pitch", "energy"):
        assert abs(float(got[key]) - float(stats[key])) <= 1e-5 * max(1.0, abs(
            float(stats[key]))), key
    assert float(stats["grad_norm"]) > tcfg.clip_grad_norm  # the clip is active

    # gradients (as the Tacotron step's test holds them)
    want = _state_of(model_type, {"params": opt_state[0]})
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        ref = scale if name.endswith("conv.weight") else float(want[name].abs().max())
        ref = ref if ref > 1e-6 * scale else scale
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * ref, (name, err, ref)

    # Adam's first update is ±lr where the gradient is well above 1e-8 (see
    # test_torch_taco_train.test_tacotron_step_matches_jax)
    new = _state_of(model_type, {"params": params, "batch_stats": new_stats}
                    if model_type == "forward-tacotron" else {"params": params})
    for name, p in model.named_parameters():
        delta, jdelta = p.detach() - before[name], new[name] - before[name]
        clear = want[name].abs() > 1e-5 * scale
        assert float((delta - jdelta).abs().max()) <= 1.01 * lr, name
        if bool(clear.any()):
            assert float((delta - jdelta)[clear].abs().max()) <= 1e-3 * lr, name
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new[name].numpy(), atol=2e-5, err_msg=name)


def test_bilstm_input_gradient_is_zero_on_pad_frames():
    _, _, _, _, model, _ = _setup("forward-tacotron")
    g = torch.Generator().manual_seed(3)
    lens = torch.tensor([10, 7, 3])
    x = torch.randn(3, 10, model.lstm.weight_ih_l0.shape[1], generator=g, requires_grad=True)
    out = tft.bilstm_packed(model.lstm, x, lens, -11.5129)
    out.backward(torch.randn(out.shape, generator=g))
    pad = torch.arange(10)[None, :] >= lens[:, None]
    assert float(x.grad[pad].abs().max()) == 0.0
    assert float(x.grad[~pad].abs().min(dim=-1).values.max()) > 0.0
    assert torch.all(out[pad] == -11.5129)


def test_masked_l1_matches_jax():
    rng = np.random.default_rng(4)
    pred, target = (rng.standard_normal((3, 5, 9)).astype(np.float32) for _ in range(2))
    lens = np.array([9, 4, 0])
    want = jsteps._masked_l1_lastdim(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(lens))
    got = tsteps.masked_l1_lastdim(torch.from_numpy(pred), torch.from_numpy(target),
                                   torch.from_numpy(lens))
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# Trainer and entry point on a root the alignment pass wrote
# ---------------------------------------------------------------------------

SCHEDULE = ((1, 2, 1e-2, 5e-3), (2, 3, 5e-3, 1e-3))
SMALL = {"forward-tacotron": ForwardTacotronParams(**FT_CFG).replace(tts_schedule=SCHEDULE),
         "fast-pitch": FastPitchParams(**FP_CFG).replace(tts_schedule=SCHEDULE)}


@pytest.fixture(scope="module")
def aligned_root(tmp_path_factory):
    from test_torch_align import aligned_root as make

    return make(tmp_path_factory.mktemp("nar"), n_utts=7)


def _epochs(root, model_type):
    from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator

    dataset = SynthesizerDataset(root, factories.get_model_train_elements(model_type))
    schedule = ttrain.sessions(model_type, SMALL[model_type].tts_schedule)
    return lambda session_idx, r: batch_iterator(
        dataset, batch_size=schedule[session_idx][2], r=r, seed=session_idx)


@pytest.mark.parametrize("model_type", TYPES)
def test_train_synthesizer_nar_sessions_and_resume(tmp_path, aligned_root, model_type):
    kw = dict(override_hp=SMALL[model_type], device="cpu")
    # 7 utterances: 3 batches of 2 in session 1 (3 steps), 2 of 3 in session
    # 2 over two epochs (4 steps)
    full = ttrain.train_synthesizer("a", model_type, tmp_path, _epochs(aligned_root, model_type),
                                    **kw)
    assert full["step"] == 7 and full["r"] == 1 and all(np.isfinite(full["losses"]))
    assert {"dur", "pitch", "energy", "m1", "m2", "grad_norm"} <= set(full)
    want_lrs = [ttrain.linear_session_lr(1e-2, 5e-3, s, 3) for s in range(3)] \
        + [ttrain.linear_session_lr(5e-3, 1e-3, s, 4) for s in range(4)]
    assert full["lrs"] == want_lrs
    # on one batch repeated the loss falls (over the shuffled epochs the
    # batches' own losses differ more than a few steps move them)
    batch = next(iter(_epochs(aligned_root, model_type)(0, 1)))
    repeated = ttrain.train_synthesizer("c", model_type, tmp_path, lambda i, r: [batch] * 4,
                                        max_steps=4, **kw)
    assert repeated["losses"][-1] < repeated["losses"][0], repeated["losses"]
    first = ttrain.train_synthesizer("b", model_type, tmp_path,
                                     _epochs(aligned_root, model_type), max_steps=5, **kw)
    assert first["losses"] == full["losses"][:5]
    state = torch.load(tmp_path / "b" / "b.pt", weights_only=True)
    assert state["step"] == 5 and state["model_type"] == model_type
    assert state["extras"]["r"] == 1 and state["optimizer"] is not None
    resumed = ttrain.train_synthesizer("b", model_type, tmp_path,
                                       _epochs(aligned_root, model_type), **kw)
    assert resumed["step"] == 7 and resumed["lrs"] == want_lrs[5:]
    assert len(resumed["losses"]) == 2


def test_session_batch_size_reads_the_nar_schedule(monkeypatch, tmp_path, aligned_root):
    """A non-autoregressive session's batch size is its schedule entry's
    second field (Tacotron's is the third): the entry point built batches of
    the first session's learning rate before."""
    from rtvc_tpu_torch.data import synthesizer_dataset

    sizes = []

    def recording(dataset, batch_size, r, seed):
        sizes.append((batch_size, r))
        return []

    monkeypatch.setattr(synthesizer_dataset, "batch_iterator", recording)
    monkeypatch.setattr(ttrain, "train_synthesizer",
                        lambda run_id, model_type, models_dir, epochs, **kw: epochs(0, 1))
    for model_type in TYPES:
        synthesizer_train.main(["run", model_type, str(aligned_root), "--device", "cpu"])
    assert sizes == [(16, 1), (16, 1)]
    cfg = factories.default_config("tacotron")
    assert ttrain.sessions("tacotron", cfg.tts_schedule)[0][2] == cfg.tts_schedule[0][2]


# ``python -m rtvc_tpu_torch.synthesizer_train`` with ForwardTacotron's
# defaults narrowed to ``SMALL``'s
NARROW_ENTRY = """
import runpy, sys
from rtvc_tpu_torch.config import synthesizer as cfg
cfg.forward_tacotron = cfg.ForwardTacotronParams(**{ft!r}).replace(tts_schedule={schedule!r})
sys.argv = ["synthesizer_train", *{argv!r}]
runpy.run_module("rtvc_tpu_torch.synthesizer_train", run_name="__main__")
"""


def test_nar_entry_point(tmp_path, aligned_root):
    argv = ["run", "forward-tacotron", str(aligned_root), "-m", str(tmp_path / "models"),
            "--max_steps", "2", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-c", NARROW_ENTRY.format(ft=FT_CFG, schedule=SCHEDULE, argv=argv)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    state = torch.load(tmp_path / "models" / "run" / "run.pt", weights_only=True)
    assert state["step"] == 2 and state["model_type"] == "forward-tacotron"
    assert state["extras"]["r"] == 1
    rnn = FT_CFG["rnn_dims"]
    assert state["state_dict"]["lstm.weight_hh_l0"].shape == (4 * rnn, rnn)
    lines = (tmp_path / "models" / "run" / "metrics.tsv").read_text().strip().splitlines()
    # a header, then eight values a step: loss, grad_norm, m1, m2, dur, pitch, energy, lr
    assert len(lines) == 17 and lines[2].split("\t")[:2] == ["1", "grad_norm"]
