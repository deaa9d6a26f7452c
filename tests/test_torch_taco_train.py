"""The port's Tacotron training slice against the JAX package (f32 on the
CPU, where the decoder chain runs K5's plain versions and the JAX package
its hoisted scan):

  * ``tacotron_forward`` of both packages on shared weights with dropout 0 in
    the dims, the decoder prenet's dropout off and zoneout 0: mel, attention
    and stop within 2e-5, the postnet's linear output within 1e-4, the new
    BatchNorm statistics within 1e-5;
  * one step of ``make_tacotron_train_step`` against the JAX step at narrow
    widths: loss and gradient norm within 1e-4 relative, every gradient
    within 1e-4 of its own largest entry (the conv weights ahead of a
    BatchNorm within 1e-4 of the model's largest), and the updated weights;
  * ``linear_session_lr`` against the JAX function, ``tacotron_loss`` against
    the JAX loss;
  * ``train_synthesizer`` on a tiny on-disk dataset over two sessions, with a
    resume in the middle of the second, and the entry point
    ``python -m rtvc_tpu_torch.synthesizer_train`` at full width for 2 steps.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.train import losses as jlosses
from rtvc_tpu.train import steps as jsteps
from rtvc_tpu.train import trainer as jtrain
from rtvc_tpu_torch import bridge, synthesizer_train
from rtvc_tpu_torch.config.synthesizer import TacotronParams
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.ops import rel_err
from rtvc_tpu_torch.train import losses as tlosses
from rtvc_tpu_torch.train import steps as tsteps
from rtvc_tpu_torch.train import trainer as ttrain

REPO = Path(__file__).resolve().parents[1]
DIMS = dict(num_chars=30, n_mels=12, fft_bins=12, speaker_embedding_size=32, embed_dims=32,
            encoder_dims=32, decoder_dims=64, postnet_dims=32, encoder_K=4, postnet_K=4,
            num_highways=2, lstm_dims=64, max_r=5, dropout=0.0, stop_threshold=-3.4)


def _setup(seed=0, B=3, T=11, steps=12):
    jd, td = jt.TacotronDims(**DIMS), tt.TacotronDims(**DIMS)
    v = jt.init_tacotron(jax.random.PRNGKey(seed), jd)
    rng = np.random.default_rng(seed)
    # running statistics away from their initial values, so that a wrong
    # momentum or a missed update shows
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    model = tt.Tacotron(td)
    model.load_state_dict(bridge.tacotron_state(v))
    lens = rng.integers(T - 4, T + 1, B)
    chars = np.where(np.arange(T)[None, :] < lens[:, None],
                     rng.integers(1, DIMS["num_chars"], (B, T)), 0).astype(np.int32)
    spec_lens = rng.integers(steps - 5, steps, B)
    batch = {"chars": chars,
             "mels": rng.uniform(-4, 4, (B, DIMS["n_mels"], steps)).astype(np.float32),
             "embeds": rng.standard_normal((B, 32)).astype(np.float32),
             "stop": (np.arange(steps)[None, :] >= spec_lens[:, None] - 1).astype(np.float32)}
    return jd, td, v, model, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _zero_zoneout(td, n_iters, B):
    zero = torch.zeros(n_iters, B, td.lstm_dims)
    return zero, zero


@pytest.mark.parametrize("r", [3, 2])
def test_tacotron_forward_matches_jax(monkeypatch, r):
    monkeypatch.setattr(jt, "_ZONEOUT_P", 0.0)
    jd, td, v, model, batch = _setup()
    want = jt.tacotron_forward(v, jd, jnp.asarray(batch["chars"]), jnp.asarray(batch["mels"]),
                               jnp.asarray(batch["embeds"]), r, jax.random.PRNGKey(1),
                               train=True, prenet_dropout=False, hoisted=True, fused=False)
    b = _torch_batch(batch)
    with torch.no_grad():
        got = tt.tacotron_forward(model.train(), td, b["chars"], b["mels"], b["embeds"], r,
                                  prenet_dropout=False,
                                  zoneout_masks=_zero_zoneout(td, 12 // r, 3))
    for name, a, w, tol in zip(("mel", "linear", "attn", "stop"), got, want,
                               (2e-5, 1e-4, 2e-5, 2e-5)):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=tol, err_msg=name)
    new = bridge.tacotron_state({"params": v["params"], "batch_stats": want[4]})
    buffers = dict(model.named_buffers())
    assert set(got[4]) == set(buffers)
    for name, value in got[4].items():
        np.testing.assert_allclose(value.numpy(), new[name].numpy(), atol=1e-5, err_msg=name)
        assert not torch.equal(value, buffers[name]), name  # returned, not written


def test_zoneout_masks_come_from_the_generator():
    _, td, _, model, batch = _setup()
    b = _torch_batch(batch)

    def run(seed):
        with torch.no_grad():
            return tt.tacotron_forward(model, td, b["chars"], b["mels"], b["embeds"], 3,
                                       torch.Generator().manual_seed(seed),
                                       prenet_dropout=False)[0]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    zo1, zo2 = tt.draw_zoneout_masks(50, 4, 64, "cpu", torch.Generator().manual_seed(0))
    assert set(zo1.unique().tolist()) == {0.0, 1.0} and not torch.equal(zo1, zo2)
    assert abs(float(zo1.mean()) - tt.ZONEOUT_P) < 0.02


def recorded(opt):
    """``opt`` after a transformation that keeps the incoming (final)
    gradients in the optimizer state, so a JAX step exposes them."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, opt)


def test_tacotron_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jt, "_ZONEOUT_P", 0.0)
    jd, td, v, model, batch = _setup(seed=1)
    r, lr = 3, 1e-3
    opt = recorded(optax.adam(lr))
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731 (the step donates)
    params, new_stats, opt_state, stats, jattn = jsteps.make_tacotron_train_step(jd, opt, r, 1.0)(
        copy(v["params"]), copy(v["batch_stats"]), opt.init(v["params"]),
        {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(2))

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = tsteps.make_tacotron_train_step(model.train(), td,
                                           ttrain.make_optimizer(model.parameters(), lr), r, 1.0)
    got, attn = step(_torch_batch(batch), zoneout_masks=_zero_zoneout(td, 12 // r, 3))
    for key in ("loss", "grad_norm", "m1", "m2", "stop"):
        assert rel_err(got[key], torch.tensor(float(stats[key]))) <= 1e-4, key
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), atol=2e-5)

    # The conv weights ahead of a BatchNorm get differences of near-equal sums
    # (the BatchNorm subtracts the batch mean of its cotangent), which both
    # frameworks round in f32 to about 1e-4 of their own size: those are held
    # to the model's largest gradient, every other gradient to its own.
    want = bridge.tacotron_state({"params": opt_state[0]})
    scale = max(float(g.abs().max()) for g in want.values())
    assert float(stats["grad_norm"]) > 1.0  # the clip is active
    for name, p in model.named_parameters():
        ref = scale if name.endswith("conv.weight") else float(want[name].abs().max())
        ref = ref if ref > 1e-6 * scale else scale
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * ref, (name, err, ref)

    # Adam's first update is lr · g / (|g| + 1e-8): it is ±lr wherever the
    # gradient is well above 1e-8 and magnifies f32 noise where it is not, so
    # the updated weights are held to 1e-3 of lr there and to lr elsewhere
    new = bridge.tacotron_state({"params": params, "batch_stats": new_stats})
    for name, p in model.named_parameters():
        delta, jdelta = p.detach() - before[name], new[name] - before[name]
        clear = want[name].abs() > 1e-5 * scale
        assert float((delta - jdelta).abs().max()) <= 1.01 * lr, name
        if bool(clear.any()):
            assert float((delta - jdelta)[clear].abs().max()) <= 1e-3 * lr, name
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new[name].numpy(), atol=1e-5, err_msg=name)


def test_tacotron_loss_matches_jax():
    rng = np.random.default_rng(0)
    m1, m2, mels = (rng.standard_normal((2, 5, 9)).astype(np.float32) for _ in range(3))
    stop_pred = rng.uniform(0, 1, (2, 9)).astype(np.float32)
    stop_pred[0, :2] = (0.0, 1.0)  # the clip's two ends
    target = (rng.uniform(0, 1, (2, 9)) > 0.7).astype(np.float32)
    want, wparts = jlosses.tacotron_loss(*(jnp.asarray(a) for a in (m1, m2, stop_pred, mels,
                                                                    target)))
    got, parts = tlosses.tacotron_loss(*(torch.from_numpy(a) for a in (m1, m2, stop_pred, mels,
                                                                      target)))
    assert abs(float(got) - float(want)) <= 1e-5
    for k in ("m1", "m2", "stop"):
        assert abs(float(parts[k]) - float(wparts[k])) <= 1e-5, k


@pytest.mark.parametrize("init_lr,end_lr,step,steps", [
    (1e-3, 1e-7, 0, 10), (1e-3, 1e-7, 4, 10), (1e-3, 1e-7, 9, 10), (1e-3, 1e-7, 12, 10),
    (5e-4, 1e-5, 0, 1), (5e-4, 1e-5, -1, 3)])
def test_linear_session_lr_matches_jax(init_lr, end_lr, step, steps):
    assert ttrain.linear_session_lr(init_lr, end_lr, step, steps) == \
        jtrain.linear_session_lr(init_lr, end_lr, step, steps)


# ---------------------------------------------------------------------------
# Trainer: sessions, resume, entry point
# ---------------------------------------------------------------------------

SMALL = TacotronParams(embed_dims=16, encoder_dims=16, decoder_dims=32, postnet_dims=16,
                       encoder_K=4, lstm_dims=32, postnet_K=4, num_highways=2,
                       tts_schedule=((3, 1, 2, 1e-3, 1e-4), (2, 2, 2, 5e-4, 1e-5)))


def _make_syn_dataset(root, n_utts, frames=(9, 15), n_mels=80):
    rng = np.random.default_rng(0)
    (root / "mels").mkdir(parents=True)
    (root / "embeds").mkdir(parents=True)
    meta = {}
    for i in range(n_utts):
        uid = f"utt{i:03d}"
        n = int(rng.integers(*frames))
        np.save(root / "mels" / f"mel-{uid}.npy",
                rng.uniform(-4, 4, (n, n_mels)).astype(np.float32))
        e = rng.standard_normal(768).astype(np.float32)
        np.save(root / "embeds" / f"embed-{uid}.npy", e / np.linalg.norm(e))
        text = " ".join(["hello there"] * int(rng.integers(1, 3))) + f" {i}"
        meta.setdefault(f"spk{i % 3}", []).append(f"{uid}|{n * 200}|{n}|{text}")
    (root / "train.json").write_text(json.dumps(meta))
    return root


def _epochs(root):
    from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator

    dataset = SynthesizerDataset(root, factories.get_model_train_elements("tacotron"))
    return lambda session_idx, r: batch_iterator(
        dataset, batch_size=SMALL.tts_schedule[session_idx][2], r=r, seed=session_idx)


def test_train_synthesizer_sessions_and_resume(tmp_path):
    root = _make_syn_dataset(tmp_path / "syn", 6)
    kw = dict(override_hp=SMALL, device="cpu")
    # 3 batches an epoch: session 1 has 3 steps at r 3, session 2 has 6 at r 2
    full = ttrain.train_synthesizer("a", "tacotron", tmp_path, _epochs(root), **kw)
    assert full["step"] == 9 and full["r"] == 2 and all(np.isfinite(full["losses"]))
    want_lrs = [ttrain.linear_session_lr(1e-3, 1e-4, s, 3) for s in range(3)] \
        + [ttrain.linear_session_lr(5e-4, 1e-5, s, 6) for s in range(6)]
    assert full["lrs"] == want_lrs
    first = ttrain.train_synthesizer("b", "tacotron", tmp_path, _epochs(root),
                                     max_steps=5, **kw)
    assert first["step"] == 5 and first["lrs"] == want_lrs[:5]
    assert first["losses"] == full["losses"][:5]  # seeded by (seed, step): runs repeat
    state = torch.load(tmp_path / "b" / "b.pt", weights_only=True)
    assert state["step"] == 5 and state["model_type"] == "tacotron"
    assert state["extras"]["r"] == 2 and state["optimizer"] is not None
    sd = first["model"].state_dict()
    assert set(state["extras"]["batch_stats"]) == {k for k in sd if "running_" in k}
    # the resume skips session 1, takes up session 2's decay at its third
    # step and stops at the session's end, not after two more whole epochs
    resumed = ttrain.train_synthesizer("b", "tacotron", tmp_path, _epochs(root), **kw)
    assert resumed["step"] == 9 and len(resumed["losses"]) == 4
    assert resumed["lrs"] == want_lrs[5:]
    again = ttrain.train_synthesizer("b", "tacotron", tmp_path, _epochs(root), **kw)
    assert again["step"] == 9 and again["losses"] == []


def test_train_synthesizer_refusals(tmp_path):
    root = _make_syn_dataset(tmp_path / "syn", 4)
    with pytest.raises(TypeError, match="sized"):
        ttrain.train_synthesizer("c", "tacotron", tmp_path,
                                 lambda i, r: iter(_epochs(root)(i, r)), override_hp=SMALL,
                                 device="cpu")
    # the non-autoregressive types train now (tests/test_torch_nar_train.py);
    # an unsized source stops them the same way, and a type no factory knows
    # raises
    for model_type in ("forward-tacotron", "fast-pitch"):
        with pytest.raises(TypeError, match="sized"):
            ttrain.train_synthesizer("e", model_type, tmp_path,
                                     lambda i, r: iter(_epochs(root)(i, r)), device="cpu")
    with pytest.raises(NotImplementedError, match="Invalid model"):
        ttrain.train_synthesizer("e", "glow-tts", tmp_path, _epochs(root), device="cpu")
    with pytest.raises(SystemExit):  # argparse refuses a type it does not list
        synthesizer_train.main(["run", "glow-tts", str(tmp_path / "missing")])


def test_entry_points_need_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factories.init_syn_model("tacotron")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factories.init_encoder_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factories.init_voc_model("runtimeracer-wavernn")
    root = _make_syn_dataset(tmp_path / "syn", 4)
    with pytest.raises((RuntimeError, AssertionError)):
        ttrain.train_synthesizer("f", "tacotron", tmp_path, _epochs(root),
                                 override_hp=SMALL, device="cuda")


def test_synthesizer_entry_point(tmp_path):
    root = _make_syn_dataset(tmp_path / "syn", 112, frames=(6, 10))
    proc = subprocess.run(
        [sys.executable, "-m", "rtvc_tpu_torch.synthesizer_train", "run", str(root), "-m",
         str(tmp_path / "models"), "--max_steps", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    state = torch.load(tmp_path / "models" / "run" / "run.pt", weights_only=True)
    assert state["step"] == 2 and state["model_type"] == "tacotron"
    # 112 utterances are one batch of session 1 (r 7, batch 112); the second
    # step is session 2's first (r 6, batch 100), with the step rebuilt
    assert state["extras"]["r"] == 6
    assert state["state_dict"]["decoder.res_rnn1.weight_hh"].shape == (4 * 512, 512)
    lines = (tmp_path / "models" / "run" / "metrics.tsv").read_text().strip().splitlines()
    # a header, then six values a step: loss, grad_norm, m1, m2, stop, lr
    assert len(lines) == 13 and lines[2].split("\t")[:2] == ["1", "grad_norm"]
