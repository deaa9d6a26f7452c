"""The counts against figures worked by hand."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from port_bench.counts import flops

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                  / "sv2tts_tacotron_rr.json").read_text())


def test_k1_bound_at_the_clone():
    # runtimeracer: 8 GRU matrices of 768 x 256 and FCs of 4 x 256 x 256 + 1024 x 256,
    # 2,097,152 elements; 2 x 13 x 8000 x 2,097,152 = 436.2 GFLOP at 67 TFLOP/s
    mats, _ = flops.k1_weights(CFG["vocoder"])
    assert mats == 2_097_152
    assert flops.k1_bound_s(CFG["vocoder"], [(13, 8000)]) * 1e3 == pytest.approx(6.5106, abs=1e-4)


def test_k1_bytes_side():
    f, b = flops.k1(CFG["vocoder"], 13, 8000)
    # streams 1536 floats a fold and step plus the sample, the weights once
    assert b == 4 * (flops.k1_weights(CFG["vocoder"])[1] + 13 * 8000 * 1537)
    assert flops.bound_s(b, f)[1] == "operations"


def test_k2_at_the_clone():
    t = CFG["synthesizer"]
    D, L, M, E = 256, 512, 80, 896
    mats = (M * 2 * D + 2 * D * 2 * D + 3 * D * (E + 2 * D) + 3 * D * D + D * D + L * (E + D)
            + 16 * L * L + (L + E) + 2 * M * L)
    att = 64 * (32 * 31 + D * 32 + D + E)
    assert flops.k2(t, 2, 200, 1, 64) == 2.0 * 200 * (mats + att)


def test_k5_forward_at_the_first_session():
    t = CFG["synthesizer"]
    D, L, E, T = 256, 512, 896, 160
    mats = D * 3 * D + D * D + (E + D) * L + 16 * L * L + E * 3 * D
    f, _ = flops.k5_fwd(t, 112, 86, T)
    assert f == 2.0 * 86 * 112 * (mats + T * D * 31 + 2 * T * D + T * E)
    fb, bb = flops.k5_bwd(t, 112, 86, T)
    assert fb == f and bb > flops.k5_fwd(t, 112, 86, T)[1]


def test_cbhg_postnet():
    # K 8 over 80 mels into 128, projections 3 x (8*128) x 128 and 3 x 128 x 80, a
    # pre-highway 80 -> 128, four highways, a BiGRU of 64
    macs = 36 * 80 * 128 + 3 * 1024 * 128 + 3 * 128 * 80 + 80 * 128 + 8 * 128 * 128 \
        + 2 * (3 * 64 * 128 + 3 * 64 * 64)
    assert flops.cbhg(512, 8, 80, 128, (128, 80), 4, 64, True) == 2.0 * 512 * macs
