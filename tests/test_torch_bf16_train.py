"""The port's training steps under the bf16 policy against the JAX package's
bf16 steps, on the CPU at narrow widths, on shared weights (the seeded
models and batches of the f32 step tests, carried across by the JAX
importers and ``bridge``):

  * GE2E (the JAX LSTM on its fused kernel in interpret mode: the hidden
    width 128 meets its gate), Tacotron at r 3 with zoneout 0 (the JAX
    decoder on its scan, with bf16 state where the port's K5 keeps f32),
    ForwardTacotron and FastPitch, and WaveRNN runtimeracer RAW (the JAX GRUs
    on their fused kernel in interpret mode), fatchord MOL and geneing BITS;
  * one bf16 step of each against the JAX bf16 step: every product of the
    port's Linear and Conv1d layers in bf16 (the policy took effect: a step
    that ran in f32 would sit within the gradient margins below, whose
    allowance includes the JAX bf16 step's distance from the f32 one), the
    loss within 2 %
    relative, every gradient within 5e-2 of the JAX gradient's L2 norm (or
    of 1e-2 of the largest leaf's for a leaf below that, of the largest
    leaf's for the conv weights ahead of a BatchNorm) beyond the JAX
    bf16 gradient's own distance from the JAX f32 gradient
    (``_leaf_margin``); the parameters f32 after the step;
  * the port's first bf16 loss within 5 % of its f32 loss on the same
    weights and batch, and a falling bf16 loss over a few steps on that
    batch (the gates ``tests/test_learning.py`` holds the JAX package to);
  * Adam's state f32 after a bf16 step, a vocoder run that resumes under
    the other policy, and the three entry points with ``--compute_dtype
    bf16`` on the CPU (the synthesizer's at ForwardTacotron's narrow widths).
"""
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_nar_train as nar
from test_torch_nar_train import aligned_root  # noqa: F401 (a fixture)
import test_torch_taco_train as taco
import test_torch_train as enc_voc
from rtvc_tpu.models import speaker_encoder as jspk
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.train import steps as jsteps
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import speaker_encoder as tspk
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import precision
from rtvc_tpu_torch.train import steps as tsteps
from rtvc_tpu_torch.train import trainer as ttrain

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
CASES = ("ge2e", "tacotron", "forward-tacotron", "fast-pitch", "runtimeracer-wavernn/RAW",
         "fatchord-wavernn/MOL", "geneing-wavernn/BITS")
GE2E = enc_voc.EncoderModelParams(model_hidden_size=128, model_embedding_size=24,
                                  model_num_layers=2)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)  # the JAX steps donate their inputs


class Case:
    """One trainer at narrow widths: ``jax_step(dtype)`` → (loss, gradients
    under the port's state-dict names); ``port_step(model, dtype)`` → a
    closure that runs one step and returns its loss; ``model`` the port's
    model on the shared weights."""

    def __init__(self, name, monkeypatch):
        self.name = name
        # the conv weights ahead of a BatchNorm, which the f32 step tests
        # hold to the model's largest gradient (the BatchNorm subtracts the
        # batch mean of their cotangent)
        self.ahead_of_bn = lambda pname: pname.endswith("conv.weight")
        getattr(self, "_" + name.split("/")[0].replace("-", "_").split("_")[0])(monkeypatch)

    def _ge2e(self, monkeypatch):
        monkeypatch.setenv("RTVC_FUSED_LSTM_TRAIN", "1")
        S, U, T = 4, 3, 12
        rng = np.random.default_rng(0)
        frames = (rng.standard_normal((S, 1, 1, 40))
                  + 0.3 * rng.standard_normal((S, U, T, 40))).reshape(S * U, T, 40)
        frames = frames.astype(np.float32)
        jmodel = jspk.SpeakerEncoder(model=enc_voc.JEncoderModelParams(**GE2E.asdict()))
        params = {"model": jmodel.init(jax.random.PRNGKey(0), frames)["params"],
                  "similarity": jspk.init_similarity_params()}
        self.model = tspk.SpeakerEncoder(GE2E)
        self.model.load_state_dict(bridge.speaker_encoder_state(params))

        def jax_step(dt):
            opt = enc_voc.recorded(optax.adam(LR))
            _, opt_state, stats, _, _ = jsteps.make_encoder_train_step(
                jmodel, opt, S, U, compute_dtype=dt)(_copy(params), opt.init(params),
                                                      jnp.asarray(frames))
            return float(stats["loss"]), bridge.speaker_encoder_state(opt_state[0])

        def port_step(model, dt):
            step = tsteps.make_encoder_train_step(
                model, ttrain.make_optimizer(model.parameters(), LR), S, U, dt)
            return lambda: step(torch.from_numpy(frames))[0]

        self.jax_step, self.port_step = jax_step, port_step

    def _tacotron(self, monkeypatch):
        monkeypatch.setattr(jt, "_ZONEOUT_P", 0.0)
        jd, td, v, self.model, batch = taco._setup(seed=1)
        r = 3

        def jax_step(dt):
            opt = enc_voc.recorded(optax.adam(LR))
            _, _, opt_state, stats, _ = jsteps.make_tacotron_train_step(
                jd, opt, r, 1.0, compute_dtype=dt)(
                _copy(v["params"]), _copy(v["batch_stats"]), opt.init(v["params"]),
                {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(2))
            return float(stats["loss"]), bridge.tacotron_state({"params": opt_state[0]})

        def port_step(model, dt):
            step = tsteps.make_tacotron_train_step(
                model.train(), td, ttrain.make_optimizer(model.parameters(), LR), r, 1.0, dt)
            zero = taco._zero_zoneout(td, 12 // r, 3)
            return lambda: step(taco._torch_batch(batch), zoneout_masks=zero)[0]["loss"]

        self.jax_step, self.port_step = jax_step, port_step

    def _forward(self, monkeypatch):
        self._nar("forward-tacotron")

    def _fast(self, monkeypatch):
        self._nar("fast-pitch")

    def _nar(self, model_type):
        # seed 2: at seed 1 ForwardTacotron predicts one duration 3e-5 from
        # its target 0, where the L1 loss's subgradient flips with any
        # rounding; _assert_no_l1_ties checks the case stays clear of that
        jd, jcfg, tcfg, v, self.model, batch = nar._setup(model_type, seed=2)
        _assert_no_l1_ties(model_type, self.model, batch)

        def jax_step(dt):
            opt = enc_voc.recorded(optax.adam(LR))
            _, _, opt_state, stats = jsteps.make_nar_synth_train_step(
                model_type, jd, opt, jcfg, compute_dtype=dt)(
                _copy(v["params"]), _copy(v.get("batch_stats", {})), opt.init(v["params"]),
                {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(2))
            return float(stats["loss"]), nar._state_of(model_type, {"params": opt_state[0]})

        def port_step(model, dt):
            step = tsteps.make_nar_synth_train_step(
                model_type, model.train(), ttrain.make_optimizer(model.parameters(), LR), tcfg,
                dt)
            return lambda: step(nar._torch_batch(batch), torch.Generator().manual_seed(2))["loss"]

        self.jax_step, self.port_step = jax_step, port_step

    def _runtimeracer(self, monkeypatch):
        self._wavernn(monkeypatch)

    def _fatchord(self, monkeypatch):
        self._wavernn(monkeypatch)

    def _geneing(self, monkeypatch):
        self._wavernn(monkeypatch)

    def _wavernn(self, monkeypatch):
        variant, mode = self.name.split("/")
        monkeypatch.setenv("RTVC_FUSED_GRU_TRAIN", "1")  # rnn_dims 128 meets its gate
        dims = {**enc_voc.VOC, "variant": variant, "mode": mode}
        jd, td = jw.WaveRNNDims(**dims), tw.WaveRNNDims(**dims)
        variables = jw.init_wavernn(jax.random.PRNGKey(0), jd)
        if mode == "MOL":  # as test_torch_train: every sample on one side of 1e-5
            last = variables["params"][tw.LAYERS[td.variant].fcs[-1].name]
            last["bias"] = last["bias"].at[20:].add(1.0)
        self.model = factories.init_wavernn(td, device="cpu").train()
        self.model.load_state_dict(bridge.wavernn_state(variables))
        ahead = {"upsample.resnet.conv_in.weight"} | {
            f"upsample.resnet.layers.{i}.{conv}.weight"
            for i in range(td.res_blocks) for conv in ("conv1", "conv2")}
        self.ahead_of_bn = ahead.__contains__
        batch = enc_voc._voc_batch(td)

        def jax_step(dt):
            opt = enc_voc.recorded(optax.adam(LR))
            _, _, opt_state, out = jsteps.make_wavernn_train_step(jd, opt, compute_dtype=dt)(
                _copy(variables["params"]), _copy(variables["batch_stats"]),
                opt.init(variables["params"]), {k: jnp.asarray(a) for k, a in batch.items()})
            return float(out["loss"]), bridge.wavernn_state({"params": opt_state[0]})

        def port_step(model, dt):
            step = tsteps.make_wavernn_train_step(
                model, td, ttrain.make_optimizer(model.parameters(), LR), dt)
            return lambda: step({k: torch.from_numpy(a) for k, a in batch.items()})

        self.jax_step, self.port_step = jax_step, port_step


def _assert_no_l1_ties(model_type, model, batch, gap=1e-2):
    """The duration, pitch and energy losses are L1 over a few dozen
    characters: where an f32 prediction lies within bf16's rounding of its
    target, the sign of its gradient is a coin flip for any bf16 step, and
    one flip moves the predictor's gradient by tens of percent. A case the
    bf16 steps are compared on keeps every prediction ``gap`` away."""
    from rtvc_tpu_torch.models import fast_pitch as tfp
    from rtvc_tpu_torch.models import forward_tacotron as tft

    fwd = (tft.forward_tacotron_forward if model_type == "forward-tacotron"
           else tfp.fastpitch_forward)
    b = nar._torch_batch(batch)
    with torch.no_grad():
        out = fwd(copy.deepcopy(model).train(), b["chars"], b["mels"], b["durations"],
                  b["embeds"], b["spec_lens"], b["pitch"], b["energy"],
                  torch.Generator().manual_seed(2))
    valid = np.arange(batch["chars"].shape[1])[None] < batch["x_lens"][:, None]
    for name, pred in zip(("durations", "pitch", "energy"),
                          (out[2], out[3][:, 0], out[4][:, 0])):
        assert np.abs(pred.numpy() - batch[name])[valid].min() >= gap, name


@pytest.mark.parametrize("name", CASES)
def test_bf16_step_matches_jax_bf16_step(monkeypatch, name):
    case = Case(name, monkeypatch)
    jloss, jgrads = case.jax_step(jnp.bfloat16)
    _, jgrads32 = case.jax_step(jnp.float32)
    model = copy.deepcopy(case.model)
    masters = list(model.parameters())
    step = case.port_step(model, "bf16")
    with precision.product_dtypes() as products:
        loss = float(step())
    # the policy took effect: every product of the model's layers in bf16
    assert products[torch.bfloat16] > 0 and set(products) == {torch.bfloat16}, products
    assert np.isfinite(loss) and abs(loss / jloss - 1) <= 2e-2, (loss, jloss)

    largest = max(float(g.norm()) for g in jgrads.values())
    margins = {}
    for pname, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, pname
        floor = largest if case.ahead_of_bn(pname) else 1e-2 * largest
        margins[pname] = _leaf_margin(p.grad, jgrads[pname], jgrads32[pname], floor)
    assert max(margins.values()) <= 1.0, sorted(margins.items(), key=lambda kv: -kv[1])[:4]
    assert all(p is q for p, q in zip(model.parameters(), masters))  # the f32 masters


def _leaf_margin(got, want, want32, floor, tol=5e-2):
    """A gradient leaf's error over what it is allowed (pass at ≤ 1): 5e-2
    of the JAX bf16 gradient's L2 norm (of ``floor`` for a leaf below that:
    1e-2 of the model's largest leaf norm, or all of it for the conv
    weights ahead of a BatchNorm, as the f32 step tests hold those), beyond
    the JAX bf16 gradient's own distance from the JAX f32 gradient. Where a
    sum cancels
    (the convs and scales ahead of a BatchNorm, the GE2E similarity bias,
    whose gradient is zero up to rounding) each framework's bf16 rounding
    moves the leaf by tens of percent of itself, so two bf16 steps can
    agree no closer than that; elsewhere that distance is small and the
    5e-2 holds."""
    allowed = tol * max(float(want.norm()), floor) + float((want - want32).norm())
    return float((got - want).norm()) / allowed


@pytest.mark.parametrize("name", CASES)
def test_bf16_step_tracks_f32_and_learns(monkeypatch, name):
    case = Case(name, monkeypatch)
    f32_loss = float(case.port_step(copy.deepcopy(case.model), "f32")())
    model = copy.deepcopy(case.model)
    step = case.port_step(model, "bf16")
    losses = [float(step()) for _ in range(4)]
    assert np.isfinite(losses).all()
    assert abs(losses[0] / f32_loss - 1) <= 5e-2, (losses[0], f32_loss)
    assert losses[-1] < losses[0], losses
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_bf16_adam_state_stays_f32():
    model = tspk.SpeakerEncoder(enc_voc.SMALL)
    for p in model.parameters():
        torch.nn.init.uniform_(p, -0.2, 0.2)
    optimizer = ttrain.make_optimizer(model.parameters(), LR)
    step = tsteps.make_encoder_train_step(model, optimizer, 2, 3, "bf16")
    step(torch.randn(6, 10, 40, generator=torch.Generator().manual_seed(0)))
    for p in model.parameters():
        state = optimizer.state[p]
        assert {t.dtype for t in state.values() if t.is_floating_point() and t.ndim} == {
            torch.float32}


def test_vocoder_run_resumes_under_the_other_policy(tmp_path):
    cfg = enc_voc._voc_cfg()
    kw = dict(override_hp=cfg, device="cpu", save_every=1)
    first = ttrain.train_vocoder("r", tw.VOC_RUNTIMERACER, tmp_path, enc_voc._voc_epochs(cfg),
                                 max_steps=2, compute_dtype="f32", **kw)
    resumed = ttrain.train_vocoder("r", tw.VOC_RUNTIMERACER, tmp_path,
                                   enc_voc._voc_epochs(cfg), compute_dtype="bf16", **kw)
    assert first["step"] == 2 and resumed["step"] == 3 and np.isfinite(resumed["losses"]).all()
    state = torch.load(tmp_path / "r" / "r.pt", weights_only=True)
    assert {t.dtype for t in state["state_dict"].values() if t.is_floating_point()} == {
        torch.float32}


@pytest.mark.parametrize("entry", ["encoder", "vocoder"])
def test_entry_point_trains_bf16(tmp_path, entry):
    models = tmp_path / "models"
    if entry == "encoder":
        data = enc_voc._make_encoder_dataset(tmp_path / "enc")
        enc_voc._run("rtvc_tpu_torch.encoder_train", "run", str(data), "-m", str(models),
                     "--speakers_per_batch", "2", "--utterances_per_speaker", "2",
                     "--total_steps", "1", "--compute_dtype", "bf16", "--device", "cpu")
    else:
        root = enc_voc._make_vocoder_dataset(tmp_path / "voc")
        enc_voc._run("rtvc_tpu_torch.vocoder_train", "run", "runtimeracer-wavernn",
                     str(tmp_path), "--voc_dir", str(root), "--syn_dir", str(root), "-m",
                     str(models), "--max_steps", "1", "--compute_dtype", "bf16", "--device",
                     "cpu")
    state = torch.load(models / "run" / "run.pt", weights_only=True)
    assert state["step"] == 1
    assert {t.dtype for t in state["state_dict"].values() if t.is_floating_point()} == {
        torch.float32}


def test_synthesizer_entry_point_trains_bf16(tmp_path, aligned_root):
    argv = ["run", "forward-tacotron", str(aligned_root), "-m", str(tmp_path / "models"),
            "--max_steps", "1", "--compute_dtype", "bf16", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-c", nar.NARROW_ENTRY.format(ft=nar.FT_CFG, schedule=nar.SCHEDULE,
                                                       argv=argv)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    state = torch.load(tmp_path / "models" / "run" / "run.pt", weights_only=True)
    assert state["step"] == 1 and state["model_type"] == "forward-tacotron"
