"""BENCHMARK.json against the benchmark contract's format, and every file a
name in it leads to."""
from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.fullmatch(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.fullmatch(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:  # each listed cell reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
        per = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert per and any("mfu" in m["name"].replace(".", "_").split("_") for m in per)


def test_files_found_by_name():
    b = ROOT / "port_bench"
    for w in BENCH["workloads"]:
        assert (b / "workloads" / f"{w['name']}.json").is_file()
        traffic = json.loads((b / "traffic" / f"{w['traffic']}.json").read_text())
        assert (b / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((b / "workloads" / f"{w['name']}.json").read_text())["limits"]
        assert limits, w["name"]
    for m in BENCH["per_layer"]:
        assert (b / "layer_metrics" / f"{m['name']}.py").is_file(), m["name"]
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (b / "layer_metrics").glob("*.py")} == listed
