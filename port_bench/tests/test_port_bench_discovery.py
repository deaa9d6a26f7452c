"""A cell, a configuration, a traffic mix and a per-layer metric added by
files alone: written into a temporary copy of the benchmark, and found by
name by the harness, which no file's edit had to teach."""
from __future__ import annotations

import json
import shutil

from port_bench.tests import tiny


def test_cell_added_by_files_alone(tmp_path):
    root = tiny.make_copy(tmp_path)
    bench_dir = root / "port_bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}

    config = json.loads((bench_dir / "configs" / "sv2tts_tacotron_rr.json").read_text())
    config["name"] = "sv2tts_tacotron_rr_alt"
    config["synthesizer"]["max_decoder_steps"] = 12
    (bench_dir / "configs" / "sv2tts_tacotron_rr_alt.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "clone.json").read_text())
    traffic["params"]["text_chars"] = {"uniform": [20, 25]}
    (bench_dir / "traffic" / "clone_short.json").write_text(json.dumps(traffic))
    shutil.copy(bench_dir / "workloads" / "tacotron_rr.clone.json",
                bench_dir / "workloads" / "tacotron_alt.clone_short.json")
    (bench_dir / "layer_metrics" / "requests_done.clone_short.py").write_text(
        "def read(run):\n    return float(len(run.latencies_s))\n")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sv2tts_tacotron_rr_alt", "source": "test",
                             "file": "port_bench/configs/sv2tts_tacotron_rr_alt.json",
                             "reduced": ["max_decoder_steps"], "why": "test"})
    bench["workloads"].append({"name": "tacotron_alt.clone_short",
                               "config": "sv2tts_tacotron_rr_alt", "traffic": "clone_short",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "clone_p90_ms":
            m["workloads"].append("tacotron_alt.clone_short")
    bench["per_layer"].append({"name": "requests_done.clone_short", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "API", "moves": "clone_p90_ms",
                               "workloads": ["tacotron_alt.clone_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    for trace, wanted in ((0, {"clone_p90_ms", "setup_s"}), (1, {"requests_done.clone_short"})):
        proc = tiny.run_cell(root, "tacotron_alt.clone_short", trace=trace)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = tiny.last_line(proc)
        assert set(line["metrics"]) == wanted
        assert line["correct"] is True, line["checks"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
