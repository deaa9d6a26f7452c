"""Each driver end to end on the CPU at tiny widths through the harness
(its look for a card skipped): the last line's shape, the port held to the
reference (every compared number far under its limit), and a planted fault
of each kind the cell can have turning ``correct`` false. The training
cells are those a later change adds as data files alone
(``tiny.LATER_CELLS``), one for each trainer of the ``train`` driver."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench.tests import tiny

CELLS = {"tacotron_rr.clone": "clone_p90_ms",
         "forward_tacotron_rr.paragraph": "audio_s_per_s",
         "tacotron_rr.train_synth": "train_step_ms",
         "tacotron_rr.train_encoder": "train_step_ms"}

# one answer altered where the program produces it, or a training step that
# leaves its state unchanged or takes half of the batch
FAULTS = {
    "tacotron_rr.clone": {
        "sample": """
import rtvc_tpu_torch.models.wavernn as w
_core = w.wavernn_generate_core
def core(*a, **k):
    out = _core(*a, **k).clone()
    out[0, out.shape[1] // 2] = -out[0, out.shape[1] // 2] + 0.5
    return out
w.wavernn_generate_core = core
""",
        "decoder": """
import rtvc_tpu_torch.inference.synthesizer as s
_dec = s.tacotron_decode
def dec(*a, **k):
    mel, attn, stops = _dec(*a, **k)
    mel = mel.clone(); mel[:, :, 5] += 0.5
    return mel, attn, stops
s.tacotron_decode = dec
""",
    },
    "forward_tacotron_rr.paragraph": {
        "durations": """
import rtvc_tpu_torch.inference.synthesizer as s
_gen = s.forward_generate
def gen(*a, **k):
    mel, d = _gen(*a, **k)
    d = d.copy(); d[0, 0] += 1
    return mel, d
s.forward_generate = gen
""",
        "mel": """
import rtvc_tpu_torch.inference.synthesizer as s
_gen = s.forward_generate
def gen(*a, **k):
    mel, d = _gen(*a, **k)
    mel = mel.clone(); mel[:, 3, 2] += 1.0
    return mel, d
s.forward_generate = gen
""",
    },
    "tacotron_rr.train_synth": {
        "state_unchanged": """
import torch
torch.optim.Adam.step = lambda self, closure=None: None
""",
        "half_batch": """
import rtvc_tpu_torch.train.steps as st
_make = st.make_tacotron_train_step
def make(*a, **k):
    step = _make(*a, **k)
    def half(batch, generator=None, **kw):
        b = {n: t[:t.shape[0] // 2] for n, t in batch.items()}
        return step(b, generator, **kw)
    return half
st.make_tacotron_train_step = make
""",
    },
    "tacotron_rr.train_encoder": {
        "state_unchanged": """
import torch
torch.optim.Adam.step = lambda self, closure=None: None
""",
        "half_batch": """
import rtvc_tpu_torch.train.steps as st
_make = st.make_encoder_train_step
def make(model, opt, S, U, *a, **k):
    step = _make(model, opt, S // 2, U, *a, **k)
    return lambda x: step(x[:S // 2 * U])
st.make_encoder_train_step = make
""",
    },
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"), later=True)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run(root, cell):
    proc = tiny.run_cell(root, cell)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = tiny.last_line(proc)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {CELLS[cell], "setup_s"}
    assert line["metrics"][CELLS[cell]]["value"] > 0
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, c in line["checks"].items():
        assert c["value"] <= 1e-5, (name, c)
    # the checks are also the last lines of standard error, each beside its limit
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_fault_is_caught(root, cell, fault):
    proc = tiny.run_cell(root, cell, before=FAULTS[cell][fault])
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = tiny.last_line(proc)
    assert line["correct"] is False, line["checks"]


def test_refuses_without_a_card(tmp_path):
    """The command itself on this CPU-only machine: no result, exit code not 0."""
    proc = subprocess.run([sys.executable, str(tiny.REPO / "port_bench" / "run.py"),
                           "--workload", "tacotron_rr.clone", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=tiny.REPO,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "card" in proc.stderr


def test_refuses_without_the_port(tmp_path):
    """A checkout that holds only BENCHMARK.json and port_bench: no result."""
    import shutil

    shutil.copytree(tiny.REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time, argparse; sys.path.insert(0, %r);"
            "from port_bench.harness import runner;"
            "a = argparse.Namespace(workload='tacotron_rr.clone', seed=1, seconds=1, trace=0);"
            "sys.exit(runner.main(a, time.perf_counter(), device='cpu'))" % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")
    json.dumps(proc.stderr)


def test_refuses_with_jax_loaded(root):
    """JAX in ``sys.modules`` once the window has closed: no result, exit not 0,
    and standard error names it."""
    proc = tiny.run_cell(root, "tacotron_rr.clone", seconds=0.5,
                         before="import sys, types; sys.modules['jax'] = types.ModuleType('jax')")
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")
    assert "jax" in proc.stderr.splitlines()[-1]
