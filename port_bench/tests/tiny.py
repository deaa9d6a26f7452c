"""A copy of the benchmark at tiny widths, for the CPU tests: the files
under ``port_bench`` and ``BENCHMARK.json`` copied into a temporary root,
each configuration narrowed (widths the port's fixed sizes allow: 80 mels,
66 symbols, 768-wide speaker embeddings), each traffic mix shortened, and a
run of a cell there on the CPU through the harness (its look for a card
skipped), in a subprocess."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_ENCODER = {"mel_channels": 40, "hidden": 32, "embedding": 768, "layers": 1}
TINY_VOCODER = {"type": "runtimeracer-wavernn", "mode": "RAW", "bits": 10, "rnn_dims": 32,
                "fc_dims": 32, "compute_dims": 16, "res_out_dims": 16, "res_blocks": 1, "pad": 2,
                "upsample_factors": [5, 5, 8], "n_mels": 80, "gen_target": 100,
                "gen_overlap": 25}
TINY_TACOTRON = dict(embed_dims=16, encoder_dims=16, decoder_dims=16, postnet_dims=16,
                     encoder_K=2, postnet_K=2, num_highways=1, lstm_dims=32,
                     max_decoder_steps=20)
TINY_FORWARD = dict(embed_dims=16, series_embed_dims=8, duration_conv_dims=16,
                    duration_rnn_dims=8, pitch_conv_dims=16, pitch_rnn_dims=8,
                    energy_conv_dims=16, energy_rnn_dims=8, prenet_dims=16, prenet_k=2,
                    prenet_num_highways=1, rnn_dims=16, postnet_dims=16, postnet_k=2,
                    postnet_num_highways=1, frames_per_char=1)


# Training cells that a later benchmark change adds as data files alone (a
# traffic mix, a workload's limits, the entries in BENCHMARK.json), at their
# full sizes; :func:`make_copy` writes them into the copy on request. The
# Tacotron cell's limits are those its chip readings set (PERF.md); the
# encoder cell's await its own readings on the card.
LATER_CELLS = {
    "tacotron_rr.train_synth": {
        "config": "sv2tts_tacotron_rr", "traffic": "train_synth",
        "params": {"trainer": "tacotron", "batch": 112, "chars": 160, "frames": 602, "r": 7,
                   "lr": 0.001, "clip": 1.0, "pool": 8, "check_steps": 3},
        "limits": {"loss_err": 4e-4, "grad1_err": 2e-4, "delta_err": 5e-3}},
    "tacotron_rr.train_encoder": {
        "config": "sv2tts_tacotron_rr", "traffic": "train_encoder",
        "params": {"trainer": "encoder", "speakers": 64, "utterances": 10, "frames": 160,
                   "lr": 1e-4, "pool": 8, "check_steps": 3},
        "limits": {"loss_err": 4e-4, "grad1_err": 2e-4, "delta_err": 5e-3}},
}


def add_later_cells(root: Path) -> None:
    """The files of :data:`LATER_CELLS` written into the copy at ``root``,
    with their entries in its BENCHMARK.json and ``train_step_ms``."""
    b = root / "port_bench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, c in LATER_CELLS.items():
        (b / "traffic" / f"{c['traffic']}.json").write_text(
            json.dumps({"driver": "train", "params": c["params"]}))
        (b / "workloads" / f"{name}.json").write_text(json.dumps({"limits": c["limits"]}))
        bench["workloads"].append({"name": name, "config": c["config"],
                                   "traffic": c["traffic"], "chips": 1, "why": "a later cell"})
    bench["end_to_end"].append({"name": "train_step_ms", "unit": "ms", "better": "lower",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": sorted(LATER_CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_config(c: dict) -> dict:
    c = json.loads(json.dumps(c))
    c["encoder"], c["vocoder"] = dict(TINY_ENCODER), dict(TINY_VOCODER)
    c["synthesizer"].update(TINY_TACOTRON if c["synthesizer"]["type"] == "tacotron"
                            else TINY_FORWARD)
    return c


def tiny_traffic(t: dict) -> dict:
    t = json.loads(json.dumps(t))
    p = t["params"]
    if t["driver"] == "train" and p["trainer"] == "encoder":
        p.update(speakers=4, utterances=3, frames=20, pool=3)
    elif t["driver"] == "train":
        p.update(batch=4, chars=16, frames=16, r=2, pool=3)
    else:
        p.update(prompt_seconds={"uniform": [1.0, 2.0]}, text_chars={"uniform": [20, 40]},
                 greedy_every=2)
        if "sentences" in p:
            p["sentences"] = {"uniform_int": [2, 3]}
    return t


def make_copy(root: Path, later: bool = False) -> Path:
    """The tiny copy under ``root`` (with ``later``, with the cells of
    :data:`LATER_CELLS` added) → its root."""
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    if later:
        add_later_cells(root)
    for p in (root / "port_bench" / "configs").glob("*.json"):
        p.write_text(json.dumps(tiny_config(json.loads(p.read_text()))))
    for p in (root / "port_bench" / "traffic").glob("*.json"):
        p.write_text(json.dumps(tiny_traffic(json.loads(p.read_text()))))
    return root


def run_cell(root: Path, cell: str, seed: int = 2 ** 31 + 17, seconds: float = 2.0,
             before: str = "", timeout: float = 600, trace: int = 0
             ) -> subprocess.CompletedProcess:
    """One run of ``cell`` in the copy at ``root`` on the CPU; ``before``: code
    run first in the subprocess (to plant a fault)."""
    code = f"""
import sys, time, argparse
sys.path.insert(0, {str(root)!r}); sys.path.insert(1, {str(REPO)!r})
import torch
torch.set_num_threads(1)
{before}
from port_bench.harness import runner
a = argparse.Namespace(workload={cell!r}, seed={seed}, seconds={seconds}, trace={trace})
sys.exit(runner.main(a, time.perf_counter(), device="cpu"))
"""
    env = {"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin", "HOME": str(root)}
    import os

    env = {**os.environ, **env}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=timeout, env=env)


def last_line(proc: subprocess.CompletedProcess) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])
