"""The port's training slice against the JAX package at narrow widths (f32
on the CPU): one GE2E step and one WaveRNN step (runtimeracer RAW, fatchord
RAW and MOL, geneing BITS) on shared weights (loss, gradient norm and every gradient by name within 1e-4
relative, the similarity matrix within 1e-5, the new BatchNorm statistics
within 1e-6); the EER,
Adam and the pruning masks; checkpoint save/resume for both trainers; and
both ``python -m rtvc_tpu_torch.*_train`` entry points on tiny on-disk
datasets."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu_torch.config.encoder import EncoderModelParams
from rtvc_tpu_torch.config.vocoder import WaveRNNParams
from rtvc_tpu.models import speaker_encoder as jspk
from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.train import pruning as jprune
from rtvc_tpu.train import steps as jsteps
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch import vocoder_train
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import speaker_encoder as tspk
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.ops import rel_err
from rtvc_tpu_torch.train import pruning as tprune
from rtvc_tpu_torch.train import steps as tsteps
from rtvc_tpu_torch.train import trainer as ttrain

REPO = Path(__file__).resolve().parents[1]
SMALL = EncoderModelParams(model_hidden_size=32, model_embedding_size=24, model_num_layers=3)
JSMALL = JEncoderModelParams(**SMALL.asdict())  # the JAX package gets its own class
VOC = dict(variant="runtimeracer-wavernn", mode="RAW", rnn_dims=128, fc_dims=16, bits=6,
           pad=2, upsample_factors=(2, 2, 5), feat_dims=10, compute_dims=8,
           res_out_dims=16, res_blocks=1, hop_length=20, sample_rate=1000)


def recorded(opt):
    """``opt`` after a transformation that keeps the incoming (final)
    gradients in the optimizer state, so a JAX step exposes them."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, opt)


def assert_grads_match(model, jax_grads_sd, model_scale=()):
    """Every gradient within 1e-4 of its own largest reference entry; those
    named in ``model_scale`` within 1e-4 of the model's largest reference
    gradient. A gradient that is zero up to rounding (the GE2E bias's: the
    softmax is invariant to a shift) is always held to the model's largest
    one."""
    scale = max(float(g.abs().max()) for g in jax_grads_sd.values())
    for name, p in model.named_parameters():
        want = jax_grads_sd[name]
        ref = scale if name in model_scale else float(want.abs().max())
        ref = ref if ref > 1e-6 * scale else scale
        err = float((p.grad - want).abs().max())
        assert err <= 1e-4 * ref, (name, err, ref)


def test_encoder_step_matches_jax():
    S, U, T = 4, 3, 20
    rng = np.random.default_rng(0)
    # each speaker's frames scatter around a signature of their own, so the
    # embeddings are apart and the cosines do not cancel to f32 rounding
    frames = (rng.standard_normal((S, 1, 1, 40))
              + 0.3 * rng.standard_normal((S, U, T, 40))).reshape(S * U, T, 40)
    frames = frames.astype(np.float32)
    jmodel = jspk.SpeakerEncoder(model=JSMALL)
    params = {"model": jmodel.init(jax.random.PRNGKey(0), frames)["params"],
              "similarity": jspk.init_similarity_params()}
    model = tspk.SpeakerEncoder(SMALL)
    model.load_state_dict(bridge.speaker_encoder_state(params))

    opt = recorded(optax.adam(1e-3))
    jstep = jsteps.make_encoder_train_step(jmodel, opt, S, U)
    _, opt_state, stats, jsim, _ = jstep(jax.tree_util.tree_map(jnp.array, params),
                                         opt.init(params), jnp.asarray(frames))
    step = tsteps.make_encoder_train_step(model, ttrain.make_optimizer(model.parameters(), 1e-3),
                                          S, U)
    loss, gnorm, sim, embeds = step(torch.from_numpy(frames))
    assert embeds.shape == (S, U, 24)
    assert rel_err(loss, torch.tensor(float(stats["loss"]))) <= 1e-4
    assert rel_err(gnorm, torch.tensor(float(stats["grad_norm"]))) <= 1e-4
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), atol=1e-5)
    assert_grads_match(model, bridge.speaker_encoder_state(opt_state[0]))


def test_similarity_matrix_matches_jax():
    e = np.random.default_rng(1).standard_normal((5, 4, 8)).astype(np.float32)
    e /= np.linalg.norm(e, axis=2, keepdims=True)
    sim = jspk.init_similarity_params()
    want = jspk.similarity_matrix(jnp.asarray(e), sim["similarity_weight"],
                                  sim["similarity_bias"])
    tsim = tspk.init_similarity_params()
    got = tspk.similarity_matrix(torch.from_numpy(e), tsim["similarity_weight"],
                                 tsim["similarity_bias"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("S,U,seed", [(4, 5, 0), (8, 10, 1), (64, 10, 2)])
def test_compute_eer_matches_jax(S, U, seed):
    rng = np.random.default_rng(seed)
    truth = np.repeat(np.arange(S), U)
    sim = rng.normal(0, 1, (S * U, S)) + 1.5 * np.eye(S)[truth]
    got, want = tspk.compute_eer(sim, S), jspk.compute_eer(sim, S)
    assert 0.0 < want < 0.5
    assert abs(got - want) <= 1e-6


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    p0 = rng.normal(0, 1, (6, 5)).astype(np.float32)
    grads = [rng.normal(0, 1e-2 * (k + 1), (6, 5)).astype(np.float32) for k in range(4)]
    opt = optax.adam(1e-3)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = ttrain.make_optimizer([tp], 1e-3)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0)


def _voc_batch(d, B=2, seed=3):
    rng = np.random.default_rng(seed)
    T = d.hop_length
    x = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    y = rng.integers(0, 2 ** d.bits, (B, T)).astype(np.int32)
    return {"x": x,
            "y": y,
            "y_float": (2.0 * y / (2 ** d.bits - 1.0) - 1.0).astype(np.float32),
            "mels": rng.uniform(-1, 1, (B, d.feat_dims, 1 + 2 * d.pad)).astype(np.float32)}


@pytest.mark.parametrize("fused", ["0", "1"])
def test_wavernn_step_matches_jax(monkeypatch, fused):
    _wavernn_step_matches_jax(monkeypatch, fused, VOC)


# the other cells that train, at the same tolerances; the JAX step on its
# scan and on its fused GRU kernel
@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("variant,mode", [("fatchord-wavernn", "RAW"), ("fatchord-wavernn", "MOL"),
                                          ("geneing-wavernn", "BITS"), ("geneing-wavernn", "MOL"),
                                          ("runtimeracer-wavernn", "MOL")])
def test_wavernn_variant_step_matches_jax(monkeypatch, variant, mode, fused):
    _wavernn_step_matches_jax(monkeypatch, fused, {**VOC, "variant": variant, "mode": mode})


def test_geneing_raw_training_raises():
    """The beta head has no cross entropy: the step refuses the cell, and so
    does the trainer, while generation of it works (test_torch_wavernn)."""
    td = tw.WaveRNNDims(**{**VOC, "variant": "geneing-wavernn", "mode": "RAW"})
    model = factories.init_wavernn(td, device="cpu")
    with pytest.raises(NotImplementedError, match="beta head"):
        tsteps.make_wavernn_train_step(model, td, ttrain.make_optimizer(model.parameters()))


def _wavernn_step_matches_jax(monkeypatch, fused, dims):
    jd, td = jw.WaveRNNDims(**dims), tw.WaveRNNDims(**dims)
    variables = jw.init_wavernn(jax.random.PRNGKey(0), jd)
    if td.mode == "MOL":
        # The mixture loss switches formula where a bin's probability mass
        # crosses 1e-5, which at the initial log-scales (about 0) is within
        # f32 rounding of where the samples sit: the two frameworks then pick
        # different branches for single samples. Wider scales keep every
        # sample on one side.
        last = variables["params"][tw.LAYERS[td.variant].fcs[-1].name]
        last["bias"] = last["bias"].at[20:].add(1.0)
    model = factories.init_wavernn(td, device="cpu").train()
    model.load_state_dict(bridge.wavernn_state(variables))
    batch = _voc_batch(td)

    monkeypatch.setenv("RTVC_FUSED_GRU_TRAIN", fused)
    opt = recorded(optax.adam(1e-3))
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731 (the step donates)
    _, new_stats, opt_state, out = jsteps.make_wavernn_train_step(jd, opt)(
        copy(variables["params"]), copy(variables["batch_stats"]),
        opt.init(variables["params"]), {k: jnp.asarray(v) for k, v in batch.items()})
    step = tsteps.make_wavernn_train_step(model, td,
                                          ttrain.make_optimizer(model.parameters(), 1e-3))
    loss = step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert rel_err(loss, torch.tensor(float(out["loss"]))) <= 1e-4
    # The conv weights ahead of a BatchNorm get differences of near-equal sums
    # (the BatchNorm subtracts the batch mean of its cotangent), which both
    # frameworks round in f32 to about 1e-4 of their own size (each side
    # checked against a float64 run): those are held to the model's largest
    # gradient, every other gradient to its own.
    ahead_of_bn = {"upsample.resnet.conv_in.weight"} | {
        f"upsample.resnet.layers.{i}.{conv}.weight"
        for i in range(td.res_blocks) for conv in ("conv1", "conv2")}
    if td.mode == "MOL":
        # Under the mixture loss the same cancellation reaches the scale and
        # shift of the residual blocks' first BatchNorm, whose gradients are
        # 1e-5 of the model's largest: against a float64 run both frameworks
        # are 1e-9 to 2e-8 off there, up to 2e-3 of those gradients.
        ahead_of_bn |= {f"upsample.resnet.layers.{i}.batch_norm1.{p}"
                        for i in range(td.res_blocks) for p in ("weight", "bias")}
    assert_grads_match(model, bridge.wavernn_state({"params": opt_state[0]}),
                       model_scale=ahead_of_bn)
    want = bridge.wavernn_state({"params": variables["params"], "batch_stats": new_stats})
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)


@pytest.mark.parametrize("variant", ["runtimeracer-wavernn", "fatchord-wavernn",
                                     "geneing-wavernn"])
def test_prune_masks_match_jax(variant):
    jd, td = (cls(**{**VOC, "variant": variant}) for cls in (jw.WaveRNNDims, tw.WaveRNNDims))
    variables = jw.init_wavernn(jax.random.PRNGKey(1), jd)
    model = factories.init_wavernn(td, device="cpu")
    model.load_state_dict(bridge.wavernn_state(variables))
    args = (0, 100, 0.9, 0.7, 4)  # start_prune, prune_steps, targets, group
    for step in (0, 10, 50, 150):
        want = jprune.compute_prune_masks(variables["params"], jd, jnp.asarray(step), *args)
        got = tprune.compute_prune_masks(model, td, step, *args)
        assert set(got) == {f"{n}.{k}" for n, e in want.items() for k in e}
        for name, mask in got.items():
            n, k = name.split(".")
            np.testing.assert_array_equal(mask.numpy(), np.asarray(want[n][k]), err_msg=name)
        assert tprune.count_pruned(got) == jprune.count_pruned(want)
    tprune.apply_prune_masks(model, got)
    params = dict(model.named_parameters())
    assert all(bool((params[n][m == 0] == 0).all()) for n, m in got.items())


# ---------------------------------------------------------------------------
# Trainers: checkpoints, resume, entry points
# ---------------------------------------------------------------------------


def _encoder_batches(n, S=2, U=3, T=12, seed=4):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal((S * U, T, 40))).astype(np.float32) for _ in range(n)]


def _small_encoder():
    return factories.init_encoder_model(seed=0, device="cpu", model_cfg=SMALL)


def test_train_encoder_resume_continues(tmp_path):
    batches = _encoder_batches(3)
    kw = dict(speakers_per_batch=2, utterances_per_speaker=3, learning_rate=1e-3,
              eer_every=1, device="cpu")
    full = ttrain.train_encoder("a", iter(batches), tmp_path, total_steps=3,
                                model=_small_encoder(), **kw)
    first = ttrain.train_encoder("b", iter(batches[:2]), tmp_path, total_steps=2,
                                 model=_small_encoder(), **kw)
    assert first["step"] == 2 and np.isfinite(first["eer"])
    state = torch.load(tmp_path / "b" / "b.pt", weights_only=True)
    assert state["step"] == 2 and state["optimizer"] is not None
    # the model part is a state dict in the layout the inference encoder loads
    tspk.SpeakerEncoder(SMALL).load_state_dict(state["state_dict"], strict=True)
    resumed = ttrain.train_encoder("b", iter(batches[2:]), tmp_path, total_steps=3,
                                   model=_small_encoder(), **kw)
    assert resumed["step"] == 3 and resumed["losses"] == full["losses"][2:]
    for (name, a), b in zip(full["model"].state_dict().items(),
                            resumed["model"].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def _voc_cfg(**kw):
    return WaveRNNParams(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=16,
                         res_blocks=1, seq_len=200, voc_tts_schedule=((1, 1e-3, 5e-4, 2),), **kw)


def _voc_epochs(cfg, n=3, model_type=tw.VOC_RUNTIMERACER):
    d = factories.wavernn_dims(model_type, cfg)
    batch = _voc_batch(d, seed=5)  # seq_len is one hop
    return lambda session_idx: [batch] * n


def test_train_vocoder_resume_continues(tmp_path):
    cfg = _voc_cfg()
    kw = dict(override_hp=cfg, device="cpu")
    full = ttrain.train_vocoder("a", tw.VOC_RUNTIMERACER, tmp_path, _voc_epochs(cfg), **kw)
    first = ttrain.train_vocoder("b", tw.VOC_RUNTIMERACER, tmp_path, _voc_epochs(cfg),
                                 max_steps=2, **kw)
    assert full["step"] == 3 and first["step"] == 2
    resumed = ttrain.train_vocoder("b", tw.VOC_RUNTIMERACER, tmp_path, _voc_epochs(cfg), **kw)
    assert resumed["step"] == 3 and resumed["losses"] == full["losses"][2:]
    for (name, a), b in zip(full["model"].state_dict().items(),
                            resumed["model"].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_train_vocoder_refuses_unsized_batches_and_bf16(tmp_path):
    cfg = _voc_cfg()
    batches = _voc_epochs(cfg)
    with pytest.raises(TypeError, match="sized"):
        ttrain.train_vocoder("c", tw.VOC_RUNTIMERACER, tmp_path,
                             lambda i: iter(batches(i)), override_hp=cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown compute_dtype 'f16'"):
        ttrain.train_vocoder("d", tw.VOC_RUNTIMERACER, tmp_path, batches, override_hp=cfg,
                             compute_dtype="f16", device="cpu")


@pytest.mark.parametrize("model_type,mode", [("fatchord-wavernn", "RAW"),
                                             ("fatchord-wavernn", "MOL"),
                                             ("geneing-wavernn", "BITS")])
def test_train_vocoder_takes_every_variant(tmp_path, model_type, mode):
    cfg = _voc_cfg(mode=mode, use_sparsification=True, start_prune=1, prune_steps=4)
    out = ttrain.train_vocoder("v", model_type, tmp_path, _voc_epochs(cfg, 3, model_type),
                               override_hp=cfg, device="cpu")
    assert out["step"] == 3 and all(np.isfinite(out["losses"]))
    state = torch.load(tmp_path / "v" / "v.pt", weights_only=True)
    assert state["model_type"] == model_type and state["step"] == 3
    assert set(state["state_dict"]) == set(out["model"].state_dict())
    masked = out["model"].rnn1.weight_hh_l0
    assert float((masked == 0).float().mean()) > 0.3  # pruned on the way


def test_train_vocoder_refuses_the_beta_head(tmp_path):
    cfg = _voc_cfg(mode="RAW")
    with pytest.raises(NotImplementedError, match="beta head"):
        ttrain.train_vocoder("w", "geneing-wavernn", tmp_path,
                             _voc_epochs(cfg, 1, "geneing-wavernn"), override_hp=cfg,
                             device="cpu")


@pytest.mark.parametrize("model_type", ["fatchord-wavernn", "geneing-wavernn",
                                        "runtimeracer-wavernn"])
def test_vocoder_entry_accepts_the_three_model_types(tmp_path, model_type):
    args = vocoder_train.parse_args(["run", model_type, str(tmp_path)])
    assert args.model_type == model_type
    assert vocoder_train.CONFIGS[model_type] == factories.default_config(model_type)
    assert vocoder_train.parse_args(["run", str(tmp_path)]).model_type == "runtimeracer-wavernn"
    with pytest.raises(SystemExit):
        vocoder_train.parse_args(["run", "other-wavernn", str(tmp_path), "extra"])


def _make_encoder_dataset(root, n_speakers=2, n_utts=3, n_frames=170, n_mels=40):
    rng = np.random.default_rng(0)
    for s in range(n_speakers):
        d = root / f"speaker_{s:02d}"
        d.mkdir(parents=True)
        arrays, lines = {}, []
        base = rng.standard_normal((1, n_mels))
        for u in range(n_utts):
            name = f"frames_{u}.npy"
            arrays[name] = (base + 0.1 * rng.standard_normal((n_frames, n_mels))).astype(np.float32)
            lines.append(f"{name},fake_{u}.wav")
        np.savez(d / "combined.npz", **arrays)
        (d / "_sources.txt").write_text("\n".join(lines) + "\n")
    return root


def _make_vocoder_dataset(root, n_utts=80, frames=20, n_mels=80):
    rng = np.random.default_rng(0)
    (root / "mels_gta").mkdir(parents=True)
    (root / "wav").mkdir(parents=True)
    meta = {}
    for i in range(n_utts):
        uid = f"utt{i:03d}"
        np.save(root / "mels_gta" / f"{uid}.npy",
                rng.uniform(-4, 4, (frames, n_mels)).astype(np.float32))
        wav = 0.5 * np.sin(np.linspace(0, 300, frames * 200) + i)
        np.save(root / "wav" / f"audio-{uid}.npy", wav.astype(np.float32))
        meta[uid] = f"{uid}|{frames * 200}|{frames}|text"
    (root / "synthesized.json").write_text(json.dumps(meta))
    return root


def _run(*args):
    # two OpenMP threads: the full-width steps on the CPU run faster so than
    # on every core, alone and more so beside other test workers
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]


def test_encoder_entry_point(tmp_path):
    data = _make_encoder_dataset(tmp_path / "enc")
    _run("rtvc_tpu_torch.encoder_train", "run", str(data), "-m", str(tmp_path / "models"),
         "--speakers_per_batch", "2", "--utterances_per_speaker", "2", "--total_steps", "2",
         "--device", "cpu")
    state = torch.load(tmp_path / "models" / "run" / "run.pt", weights_only=True)
    assert state["step"] == 2 and state["model_type"] == "speaker_encoder"
    assert state["state_dict"]["lstm.weight_hh_l0"].shape == (4 * 768, 768)


def test_vocoder_entry_point(tmp_path):
    root = _make_vocoder_dataset(tmp_path / "voc")
    _run("rtvc_tpu_torch.vocoder_train", "run", "runtimeracer-wavernn", str(tmp_path),
         "--voc_dir", str(root), "--syn_dir", str(root), "-m", str(tmp_path / "models"),
         "--max_steps", "2", "--device", "cpu")
    state = torch.load(tmp_path / "models" / "run" / "run.pt", weights_only=True)
    assert state["step"] == 2 and state["model_type"] == "runtimeracer-wavernn"
    assert state["state_dict"]["rnn1.weight_hh_l0"].shape == (3 * 256, 256)
