"""The references against the port at tiny widths on the CPU (so that the
comparison is not vacuous), and the control: the reference at TF32 in the
program's place reads far above the program on every number the
precision reaches."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench.harness import weights as seeded
from port_bench.reference import encoder as ref_enc
from port_bench.reference import params
from port_bench.reference.nn import Prec, round_tf32
from port_bench.tests import tiny


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_round_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12, -3.0])
    # ties to even at bit 13: 1 + 2^-11 → 1, 1 + 3·2^-11 → 1 + 2^-9, 1 + 2^-12 → 1
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0, -3.0]


def test_ge2e_step_matches_the_port():
    """The reference GE2E step (for a later encoder-training cell) against the
    port's ``make_encoder_train_step``: two steps, the same weights."""
    from rtvc_tpu_torch.config.encoder import EncoderModelParams
    from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from rtvc_tpu_torch.train import steps

    c = {"mel_channels": 40, "hidden": 16, "embedding": 12, "layers": 2}
    W0 = seeded.make(params.encoder_spec(c), 5, "cpu")
    model = SpeakerEncoder(EncoderModelParams(model_hidden_size=16, model_embedding_size=12,
                                              model_num_layers=2))
    model.load_state_dict(W0, strict=True)
    S, U, T = 4, 3, 20
    step = steps.make_encoder_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                         S, U)
    W = {k: v.clone().requires_grad_() for k, v in W0.items()}
    opt = ref_enc.Adam(1e-3)
    g = torch.Generator().manual_seed(3)
    for _ in range(2):
        x = torch.rand((S * U, T, 40), generator=g)
        loss, _, _, _ = step(x)
        ref_loss, _ = ref_enc.encoder_train_step(Prec("f32"), W, c, opt, x, S, U)
        assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, W[k].detach(), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"), later=True)


@pytest.mark.parametrize("cell,numbers", [
    # at these widths TF32 can put first the same label as float32 at every
    # step, so the logit gap is the planted sample fault's to fail here
    ("tacotron_rr.clone", ("embed_err", "decoder_err", "postnet_err")),
    ("forward_tacotron_rr.paragraph", ("embed_err", "mel_err")),
    ("tacotron_rr.train_synth", ("loss_err", "grad1_err", "delta_err")),
    ("tacotron_rr.train_encoder", ("loss_err", "grad1_err", "delta_err")),
])
def test_control_reads_above_the_program(root, cell, numbers):
    code = f"""
import sys, json
sys.path.insert(0, {str(root)!r}); sys.path.insert(1, {str(tiny.REPO)!r})
import torch; torch.set_num_threads(1)
from port_bench import control
s = control.readings({cell!r}, [2 ** 31 + 1, 7], 2, 2.0, device="cpu")
print("SUMMARY " + json.dumps(s))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.split("SUMMARY ")[-1])["summary"]
    for n in numbers:
        r = summary[n]
        assert r["control_min"] >= 3 * max(r["program_max"], 1e-7), (n, r)
    for n, r in summary.items():  # each number is failed by the control or a fault
        upper = [r["control_min"]] + list(r["faults_min"].values())
        assert max(upper) >= 3 * max(r["program_max"], 1e-7), (n, r)
