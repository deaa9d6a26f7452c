"""Where K3's time goes at a shape, by taking parts of the kernels away.

    python -m rtvc_tpu_torch.profile_lstm [B T H]

Builds ``csrc/lstm_seq.cu`` (with ``csrc/common.cuh`` written into it, where
the product ``slice_product`` lives) as it is and in variants whose source has
one part replaced by a constant, each with its own ``nvcc`` (all started
together, into a temporary directory), and times forward and backward of each with
CUDA events at the GE2E training shape (640 x 40 x 768: the time per step
does not depend on T) and at the inference shape (8 x 160 x 768):

- ``base``: the kernels of the package;
- ``no_loads``: the rows a warp multiplies are constants, not read from L2;
- ``no_weights``: the weights are constants, not read from shared memory;
- ``no_loads_no_weights``: both: the arithmetic, the sum over the lanes, the
  cell update and the barrier;
- ``clock``: the forward also counts its cycles, which with the event time
  gives the SM clock under this load.

The variants' outputs are wrong by construction; only their times are read.
Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.ops.lstm_seq import plan

FIRST_LOAD = "__ldcg(reinterpret_cast<const float4*>(x + b * xs + lane * 4))"
NEXT_LOAD = "__ldcg(reinterpret_cast<const float4*>(x + b * xs + k + 128))"
WEIGHT_LOAD = "const float4 w = load_w4(W + r * ld + k);"
CONST_WEIGHT = "const float4 w = make_float4(k, r, 1.f, 2.f);"
FWD_SETUP = "  const int G = 4 * H;\n  for (int i = threadIdx.x; i < R * ld;"
FWD_BARRIER = ("    if (t + 1 < T) rtvc::grid_barrier(p.counter, p.slices * (unsigned int)(t + 1));\n"
               "  }\n")
CLOCK_WORD = 40  # of the barrier counters' tensor: kernel cycles / 1024
BARRIER_WAIT = "    } while (seen < target);"


def flat_source(name: str) -> str:
    """``csrc/<name>`` with ``common.cuh`` written in place of its include, so
    that one text holds the kernels and the helpers they call."""
    common = (_build.SRC_DIR / "common.cuh").read_text().replace("#pragma once\n", "")
    return (_build.SRC_DIR / name).read_text().replace('#include "common.cuh"', common, 1)


def replaced(source: str, old: str, new: str) -> str:
    if old not in source:
        raise RuntimeError(f"profile: the kernel source no longer holds {old!r}")
    return source.replace(old, new, 1)


def part_variants(source: str) -> dict:
    """The source as it is and with the shared product's loads from L2, its
    weight reads from shared memory, or both replaced by constants (the
    replacements land in ``common.cuh:slice_product``, which K3, K4 and K1
    share)."""
    no_loads = replaced(replaced(source, FIRST_LOAD, "make_float4(1.f, 0.f, b, 2.f)"),
                        NEXT_LOAD, "make_float4(1.f, k, b, 2.f)")
    return {"base": source, "no_loads": no_loads,
            "no_weights": replaced(source, WEIGHT_LOAD, CONST_WEIGHT),
            "no_loads_no_weights": replaced(no_loads, WEIGHT_LOAD, CONST_WEIGHT)}


def no_wait(source: str) -> str:
    """The source with the grid barrier's wait taken out (each CTA still
    arrives): the barrier's own cost, with the steps no longer in order."""
    return replaced(source, BARRIER_WAIT, "    } while (false);")


def variants(source: str) -> dict:
    clock = replaced(source, FWD_SETUP, "  const long long c_start = clock64();\n" + FWD_SETUP)
    clock = replaced(clock, FWD_BARRIER, FWD_BARRIER + (
        "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
        f"    sync[{CLOCK_WORD}] = (unsigned int)((clock64() - c_start) >> 10);\n"))
    return {**part_variants(source), "clock": clock}


def build(tmp: Path, made: dict, functions=("rtvc_lstm_seq_fwd", "rtvc_lstm_seq_bwd")) -> dict:
    """Each variant's source built into a library of its own under ``tmp``,
    all ``nvcc`` started together; ``functions`` are bound as the package
    binds them."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, text in made.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *flags, "-I", str(_build.SRC_DIR), "-shared", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in functions:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_shape(libs: dict, B: int, T: int, H: int, dev) -> None:
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w = ((torch.rand(4 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    h0 = torch.randn(B, H, generator=g).to(dev)
    c0 = h0.clone()
    ys, cs = torch.empty(B, T, H, device=dev), torch.randn(B, T, H, generator=g).to(dev)
    gates, dxg = torch.rand(B, T, 4 * H, generator=g).to(dev), torch.empty(B, T, 4 * H, device=dev)
    hT, cT = torch.empty(B, H, device=dev), torch.empty(B, H, device=dev)
    limits = _build.device_limits(dev)
    p_fwd, p_bwd = plan(B, H, *limits), plan(B, H, *limits, backward=True)
    stream = _build.stream_handle(dev)
    print(f"B={B} T={T} H={H}: forward {p_fwd}, backward {p_bwd}")
    for name, lib in libs.items():
        def counters(p):
            return torch.zeros(max(32 * p.groups, CLOCK_WORD + 1), device=dev, dtype=torch.int32)

        def fwd():
            sync = counters(p_fwd)
            _build.check(lib.rtvc_lstm_seq_fwd(
                xg.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
                hT.data_ptr(), cT.data_ptr(), None, None, B, T, H, _build.int_array(p_fwd),
                sync.data_ptr(), stream), "rtvc_lstm_seq_fwd")
            return sync

        def bwd():
            sync = counters(p_bwd)
            _build.check(lib.rtvc_lstm_seq_bwd(
                ys.data_ptr(), h0.data_ptr(), c0.data_ptr(), gates.data_ptr(), cs.data_ptr(),
                c0.data_ptr(), w.data_ptr(), dxg.data_ptr(), hT.data_ptr(), cT.data_ptr(),
                B, T, H, _build.int_array(p_bwd), sync.data_ptr(), stream), "rtvc_lstm_seq_bwd")

        fwd_ms, bwd_ms = cuda_ms(fwd), cuda_ms(bwd)
        line = (f"  {name}: forward {fwd_ms:.3f} ms, {fwd_ms / T * 1e3:.1f} us a step; backward "
                f"{bwd_ms:.3f} ms, {bwd_ms / T * 1e3:.1f} us a step")
        if name == "clock":
            cycles = int(fwd()[CLOCK_WORD]) * 1024
            line += f"; {cycles} cycles, SM clock {cycles / fwd_ms / 1e6:.3f} GHz"
        print(line)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lstm: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    shapes = [tuple(map(int, sys.argv[1:4]))] if len(sys.argv) >= 4 else [(640, 40, 768),
                                                                          (8, 160, 768)]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), variants(flat_source("lstm_seq.cu")))
        for B, T, H in shapes:
            profile_shape(libs, B, T, H, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
