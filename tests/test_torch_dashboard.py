"""The port's copies of the trainers' tools: ``utils/dashboard.py`` serves
the metrics TSVs the port's trainers write and their PNG artifacts, as
``tests/test_dashboard.py`` holds the JAX package's; the three training
entry points take ``--dashboard PORT`` and serve the run directory before
training; ``utils/argutils.print_args`` prints what the JAX package's
prints."""
import argparse
import json
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from rtvc_tpu.utils import argutils as jargs
from rtvc_tpu_torch import encoder_train, synthesizer_train, vocoder_train
from rtvc_tpu_torch.utils import argutils as targs
from rtvc_tpu_torch.utils import dashboard
from rtvc_tpu_torch.utils.metrics import MetricsLogger


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read(), r.headers.get("Content-Type", "")


def test_dashboard_serves_metrics_and_artifacts(tmp_path):
    logger = MetricsLogger(tmp_path / "metrics.tsv")
    for step in range(30):
        logger.log(step, {"loss": 3.0 * np.exp(-step / 10), "lr": 1e-3})
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    (tmp_path / "samples").mkdir()
    fig.savefig(tmp_path / "samples" / "attention_10.png")
    plt.close(fig)

    server = dashboard.serve(tmp_path, port=0, background=True)
    try:
        port = server.server_address[1]
        status, body, ctype = _get(port, "/")
        assert status == 200 and b"dashboard" in body and "html" in ctype
        status, body, _ = _get(port, "/data.json")
        data = json.loads(body)
        assert set(data["metrics"]) == {"loss", "lr"}
        pts = data["metrics"]["loss"]
        assert pts[0][0] == 0 and pts[-1][0] == 29 and abs(pts[0][1] - 3.0) < 1e-6
        assert data["artifacts"] == ["samples/attention_10.png"]
        status, body, _ = _get(port, "/art/samples/attention_10.png")
        assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        for bad in ("/art/../metrics.tsv", "/art/metrics.tsv", "/nowhere"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(port, bad)
            assert e.value.code == 404
    finally:
        server.shutdown()


class _Served(Exception):
    pass


@pytest.mark.parametrize("module,argv", [
    (encoder_train, ["run1", "enc_root"]),
    (synthesizer_train, ["run1", "tacotron", "syn_dir"]),
    (vocoder_train, ["run1", "runtimeracer-wavernn", "datasets"])])
def test_entry_points_take_dashboard(monkeypatch, tmp_path, module, argv):
    """``--dashboard PORT`` parses (None without it) and ``main`` serves
    ``<models_dir>/<run_id>`` in the background on that port before it
    reads the dataset (the serve stops the run here)."""
    assert module.parse_args(argv).dashboard is None
    assert module.parse_args(argv + ["--dashboard", "8097"]).dashboard == 8097
    calls = []

    def serve(run_dir, port=8097, background=False, host="127.0.0.1"):
        calls.append((Path(run_dir), port, background))
        raise _Served

    monkeypatch.setattr(dashboard, "serve", serve)
    with pytest.raises(_Served):
        module.main(argv + ["-m", str(tmp_path), "--dashboard", "0", "--device", "cpu"])
    assert calls == [(tmp_path / "run1", 0, True)]


def test_entry_point_dashboard_serves_the_run(tmp_path, monkeypatch):
    """With the real server: the encoder entry point's dashboard answers
    while a stub trainer writes the run's metrics."""
    import rtvc_tpu_torch.data.ge2e_sampler as sampler
    import rtvc_tpu_torch.train.trainer as trainer

    servers = []
    real = dashboard.serve
    monkeypatch.setattr(dashboard, "serve", lambda *a, **k: servers.append(real(*a, **k)) or
                        servers[-1])
    monkeypatch.setattr(sampler, "SpeakerVerificationDataset", lambda *a, **k: None)
    monkeypatch.setattr(sampler, "speaker_batch_iterator", lambda *a, **k: iter(()))

    def train(run_id, it, models_dir, **kw):
        MetricsLogger(Path(models_dir) / run_id / "metrics.tsv").log(1, {"loss": 0.5})
        port = servers[0].server_address[1]
        return json.loads(_get(port, "/data.json")[1])

    monkeypatch.setattr(trainer, "train_encoder", train)
    try:
        data = encoder_train.main(["run2", str(tmp_path / "enc"), "-m", str(tmp_path),
                                   "--dashboard", "0", "--device", "cpu"])
    finally:
        for s in servers:
            s.shutdown()
    assert data["metrics"] == {"loss": [[1, 0.5]]}


@pytest.mark.parametrize("with_parser", [False, True])
def test_print_args_prints_as_the_original(capsys, with_parser):
    parser = argparse.ArgumentParser(prog="train")
    ns = argparse.Namespace(run_id="r", models_dir=Path("saved_models"), steps=10, lr=1e-3,
                            force=False, dashboard=None, z_last="x")
    outs = []
    for mod in (jargs, targs):
        mod.print_args(ns, parser if with_parser else None)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1].splitlines()[0] == ("Arguments (train)" if with_parser else "Arguments")
    assert all(f"  {k}" in outs[1] for k in vars(ns))
