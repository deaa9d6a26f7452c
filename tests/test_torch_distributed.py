"""The port's multi-process data parallelism (``rtvc_tpu_torch.parallel.
distributed``): two real processes over gloo on the CPU
(``tests/torch_dp_worker.py``, launched once for the file) against the port
in one process on the same global batches, and against the JAX package's
single-process step on the whole global batch.

  * the two ranks end with parameters and buffers equal bit for bit;
  * ``train_encoder`` (3 GE2E steps: the loss over the gathered global
    embeddings) equals the single process within atol 1e-5, rtol 1e-4;
    ``train_synthesizer`` for Tacotron, ForwardTacotron and FastPitch (their
    dropouts and zoneouts on, drawn for the global batch; the BatchNorms on
    the global batch's moments; the masked L1 losses over global counts) and
    ``train_vocoder`` with pruning from step 0 within atol 2e-4, rtol 1e-3,
    as the JAX package's DP tests hold theirs; the pruned share is equal on
    both ranks and above 0.1;
  * only rank 0 wrote the encoder's checkpoint; ``fetch`` gathers every
    rank's rows in rank order; a model a DP run returned trains alone once
    the group is destroyed;
  * one two-process GE2E step and one two-process Tacotron step from weights
    the bridge carried over equal the JAX step on the whole batch by the
    rules of the one-step parity tests (``test_torch_train.py``,
    ``test_torch_taco_train.py``): the Tacotron step's CBHG BatchNorms are
    the test of the global statistics.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvc_tpu.models import speaker_encoder as jspk
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.train import steps as jsteps
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.ops import rel_err
import torch_dp_worker as worker
from test_torch_taco_train import DIMS as TACO_DIMS
from test_torch_train import JSMALL, SMALL, recorded

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dp_worker.py"
STAGES = ("enc", "taco", "fwd", "fast", "voc")
TOL = {"enc": dict(atol=1e-5, rtol=1e-4), "taco": dict(atol=2e-4, rtol=1e-3),
       "fwd": dict(atol=2e-4, rtol=1e-3), "fast": dict(atol=2e-4, rtol=1e-3),
       "voc": dict(atol=2e-4, rtol=1e-3)}
ENC_S, ENC_U, ENC_T = 4, 3, 20
TACO_R, TACO_B = 3, 4


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(outdir: Path, stages: str, timeout: float = 240) -> Path:
    """Two workers over gloo on a free loopback port; each has its own
    timeout, so a hung rendezvous fails the test instead of the suite."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for name in ("RTVC_COORDINATOR", "RTVC_NUM_PROCESSES", "RTVC_PROCESS_ID"):
        env.pop(name, None)
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(pid), "2", str(port),
                               str(outdir), stages], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
    return outdir


def jax_inputs():
    """The GE2E and Tacotron parity cases: JAX variables, the port's state
    dicts the bridge made of them, and the global batches."""
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((ENC_S, 1, 1, 40))
              + 0.3 * rng.standard_normal((ENC_S, ENC_U, ENC_T, 40))).reshape(
        ENC_S * ENC_U, ENC_T, 40).astype(np.float32)
    jmodel = jspk.SpeakerEncoder(model=JSMALL)
    enc_params = {"model": jmodel.init(jax.random.PRNGKey(0), frames)["params"],
                  "similarity": jspk.init_similarity_params()}
    jd, v, model, batch = taco_case()
    return {"enc_cfg": SMALL, "enc_shape": (ENC_S, ENC_U), "enc_frames": frames,
            "enc_state": bridge.speaker_encoder_state(enc_params),
            "taco_dims": TACO_DIMS, "taco_state": model.state_dict(), "taco_batch": batch,
            "taco_r": TACO_R}, {"jmodel": jmodel, "enc_params": enc_params, "jd": jd,
                                "taco_vars": v}


def taco_case(seed=1, B=TACO_B, T=11, steps=12):
    """The port's seeded narrow Tacotron (dropout 0; running statistics away
    from their initial values, so that a wrong momentum or a missed update
    shows), its JAX variables through the JAX package's importer, and a
    seeded batch with stop targets, as ``test_torch_taco_train._setup``
    makes them."""
    jd, td = jt.TacotronDims(**TACO_DIMS), tt.TacotronDims(**TACO_DIMS)
    model = factories.init_tacotron(td, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape)).float())
    v = jt.import_torch_state({k: t.clone() for k, t in model.state_dict().items()}, jd)
    lens = rng.integers(T - 4, T + 1, B)
    chars = np.where(np.arange(T)[None, :] < lens[:, None],
                     rng.integers(1, TACO_DIMS["num_chars"], (B, T)), 0).astype(np.int32)
    spec_lens = rng.integers(steps - 5, steps, B)
    batch = {"chars": chars,
             "mels": rng.uniform(-4, 4, (B, TACO_DIMS["n_mels"], steps)).astype(np.float32),
             "embeds": rng.standard_normal((B, 32)).astype(np.float32),
             "stop": (np.arange(steps)[None, :] >= spec_lens[:, None] - 1).astype(np.float32)}
    return jd, v, model, batch


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("torch_dp")
    inputs, jax_side = jax_inputs()
    torch.save(inputs, outdir / "jax_inputs.pt")
    launch_workers(outdir, ",".join(STAGES + ("jax_enc", "jax_taco")))
    return outdir, inputs, jax_side


def load(path: Path):
    return torch.load(path, weights_only=False)


def single_process(stage: str, models_dir: Path):
    if stage == "enc":
        return worker.run_encoder(models_dir)
    if stage == "voc":
        return worker.run_vocoder(models_dir)
    return worker.run_synthesizer(stage, models_dir)


@pytest.mark.parametrize("stage", STAGES)
def test_ranks_end_bitwise_equal(run, stage):
    outdir, _, _ = run
    a, b = load(outdir / f"{stage}_0.pt"), load(outdir / f"{stage}_1.pt")
    assert a["state"].keys() == b["state"].keys()
    for name in a["state"]:
        assert torch.equal(a["state"][name], b["state"][name]), name
    assert a["losses"] == b["losses"]  # the global batch's, on every rank


@pytest.mark.parametrize("stage", STAGES)
def test_two_processes_equal_one(run, tmp_path, stage):
    outdir, _, _ = run
    want = single_process(stage, tmp_path)
    got = load(outdir / f"{stage}_0.pt")
    state = want["model"].state_dict()
    assert got["state"].keys() == state.keys()
    for name, value in state.items():
        np.testing.assert_allclose(got["state"][name].numpy(), value.numpy(), err_msg=name,
                                   **TOL[stage])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    if stage == "voc":
        pruned = [load(outdir / f"voc_{p}.pt")["pruned"] for p in (0, 1)]
        assert pruned[0] == pruned[1] == worker.pruned_fraction(want["model"])
        assert pruned[0] > 0.1, "pruning must have pruned"


def test_a_model_trains_alone_after_its_dp_run(run, tmp_path):
    """The process group is the step's, not the model's: once the group is
    destroyed, the vocoder a DP run returned (its MelResNet BatchNorms took
    the global moments in each step) runs its training forward alone, on
    its own batch's statistics, as the one-process run's model does. The
    ranks run it on batches of different sizes, so moments summed over them
    would show."""
    outdir, _, _ = run
    model = single_process("voc", tmp_path)["model"]
    for pid in (0, 1):
        want = worker.vocoder_loss_alone(model, worker.VOC_B // (pid + 1))
        np.testing.assert_allclose(load(outdir / f"alone_{pid}.pt")["loss"], want, rtol=1e-4)


def test_fetch_gathers_every_ranks_rows_in_rank_order(run):
    outdir, _, _ = run
    for pid in (0, 1):
        got = load(outdir / f"enc_{pid}.pt")["fetched"]
        assert torch.equal(got, torch.tensor([0.0, 0.0, 1.0, 1.0])[:, None].expand(4, 3))


def test_only_rank_0_wrote_a_checkpoint(run):
    outdir, _, _ = run
    assert (outdir / "proc0" / "dprun" / "dprun.pt").exists()
    assert not (outdir / "proc1" / "dprun" / "dprun.pt").exists()
    assert (outdir / "proc1" / "dprun").is_dir()  # the run directory itself is every rank's


def test_ge2e_step_equals_the_jax_step_on_the_global_batch(run):
    outdir, inputs, js = run
    opt = recorded(optax.adam(1e-3))
    jstep = jsteps.make_encoder_train_step(js["jmodel"], opt, ENC_S, ENC_U)
    params = js["enc_params"]
    _, opt_state, stats, jsim, _ = jstep(jax.tree_util.tree_map(jnp.array, params),
                                         opt.init(params), jnp.asarray(inputs["enc_frames"]))
    want_grads = bridge.speaker_encoder_state(opt_state[0])
    for pid in (0, 1):
        got = load(outdir / f"jax_steps_{pid}.pt")["enc"]
        assert rel_err(got["loss"], torch.tensor(float(stats["loss"]))) <= 1e-4
        assert rel_err(got["grad_norm"], torch.tensor(float(stats["grad_norm"]))) <= 1e-4
        np.testing.assert_allclose(got["sim"].numpy(), np.asarray(jsim), atol=1e-5)
        _assert_grads(got["grads"], want_grads)


def _assert_grads(grads, want):
    """``test_torch_train.assert_grads_match``'s rule on a dict of
    gradients: each within 1e-4 of its own largest reference entry, one
    that is zero up to rounding (the GE2E bias's) within 1e-4 of the
    model's largest."""
    assert grads.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in grads.items():
        ref = float(want[name].abs().max())
        ref = ref if ref > 1e-6 * scale else scale
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * ref, (name, err, ref)


def test_tacotron_step_equals_the_jax_step_on_the_global_batch(run, monkeypatch):
    monkeypatch.setattr(jt, "_ZONEOUT_P", 0.0)
    outdir, inputs, js = run
    v, batch, lr = js["taco_vars"], inputs["taco_batch"], 1e-3
    opt = recorded(optax.adam(lr))
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731 (the step donates)
    params, new_stats, opt_state, stats, jattn = jsteps.make_tacotron_train_step(
        js["jd"], opt, TACO_R, 1.0)(copy(v["params"]), copy(v["batch_stats"]),
                                    opt.init(v["params"]),
                                    {k: jnp.asarray(a) for k, a in batch.items()},
                                    jax.random.PRNGKey(2))
    want = bridge.tacotron_state({"params": opt_state[0]})
    new = bridge.tacotron_state({"params": params, "batch_stats": new_stats})
    before = inputs["taco_state"]
    scale = max(float(g.abs().max()) for g in want.values())
    assert float(stats["grad_norm"]) > 1.0  # the clip is active
    steps = [load(outdir / f"jax_steps_{pid}.pt")["taco"] for pid in (0, 1)]
    # each rank's attention rows, in rank order, are the global batch's
    np.testing.assert_allclose(torch.cat([s["attn"] for s in steps]).numpy(),
                               np.asarray(jattn), atol=2e-5)
    for got in steps:
        for key in ("loss", "grad_norm", "m1", "m2", "stop"):
            assert rel_err(got["stats"][key], torch.tensor(float(stats[key]))) <= 1e-4, key
        # the rules of test_torch_taco_train.test_tacotron_step_matches_jax:
        # the conv weights ahead of a BatchNorm within 1e-4 of the model's
        # largest gradient, every other gradient within 1e-4 of its own
        for name, g in got["grads"].items():
            ref = scale if name.endswith("conv.weight") else float(want[name].abs().max())
            ref = ref if ref > 1e-6 * scale else scale
            err = float((g - want[name]).abs().max())
            assert err <= 1e-4 * ref, (name, err, ref)
        for name in got["grads"]:
            delta = got["state"][name] - before[name]
            jdelta = new[name] - before[name]
            clear = want[name].abs() > 1e-5 * scale
            assert float((delta - jdelta).abs().max()) <= 1.01 * lr, name
            if bool(clear.any()):
                assert float((delta - jdelta)[clear].abs().max()) <= 1e-3 * lr, name
        # the running statistics from the global batch's moments
        for name, value in got["state"].items():
            if name not in got["grads"]:
                np.testing.assert_allclose(value.numpy(), new[name].numpy(), atol=1e-5,
                                           err_msg=name)
