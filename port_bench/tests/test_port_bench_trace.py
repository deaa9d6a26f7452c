"""The trace reduction's arithmetic."""
from __future__ import annotations

from port_bench.harness import trace


def test_union_and_gaps():
    busy, gaps = trace.union_seconds([(0, 10), (5, 20), (30, 40), (40, 45), (50, 51)])
    assert busy == (20 + 15 + 1) * 1e-6
    assert gaps == [(20, 30), (45, 50)]


def test_kernel_names():
    assert trace.kernel_name("void (anonymous namespace)::wavernn_kernel<float, float>(Layers)") \
        == "wavernn_kernel"
    assert trace.kernel_name("void fwd::tacotron_train_fwd_kernel(Weights, Inputs)") \
        == "tacotron_train_fwd_kernel"


def test_breakdown_limits():
    red = {"kernels_s": {f"k{i}": float(i) for i in range(15)},
           "gaps_s": {f"g{i}": float(i) for i in range(12)}}
    b = trace.breakdown(red)
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k14", 14.0]
    assert len(b["idle_gaps"]) == 10 and b["idle_gaps"][0] == ["g11", 11.0]
