"""Where K1's time goes, by taking parts of the sample loop away.

    python -m rtvc_tpu_torch.profile_wavernn

Builds ``csrc/wavernn_generate.cu`` (with ``common.cuh`` written into it) as
it is and in the variants of ``profile_gru``: the layers' inputs not read
from L2, the weights not read from shared memory, both, and the grid
barrier's wait taken out; and a ``clock`` build whose CTA 0 sums, with
``clock64``, a step's cycles by phase (``PHASES``: each layer kind's
product, elementwise part and grid barrier, the head's second half).
Times each, greedy, with CUDA events through the
package's plan: runtimeracer RAW at 13 folds (a 5 s clone), 169 (the
paragraph's batched vocode) and 264, fatchord RAW and geneing BITS at 13 and
at 20 (a 5 s clone at their 3000 / 1500 window), 512 steps each, with
full-width seeded random weights, and prints the clock build's cycles a
step. The variants' samples are wrong by construction; only their times
are read. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rtvc_tpu_torch import _build, profile_lstm
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import wavernn as wrn
from rtvc_tpu_torch.ops import wavernn_generate as wg
from rtvc_tpu_torch.profile_gru import variants

CASES = ((factories.MODEL_TYPE_RUNTIMERACER, 13), (factories.MODEL_TYPE_RUNTIMERACER, 169),
         (factories.MODEL_TYPE_RUNTIMERACER, 264),
         (factories.MODEL_TYPE_FATCHORD, 13), (factories.MODEL_TYPE_FATCHORD, 20),
         (factories.MODEL_TYPE_GENEING, 13), (factories.MODEL_TYPE_GENEING, 20))
STEPS = 512
PHASES = ("GRU product", "GRU elementwise", "GRU barrier", "FC product", "FC elementwise",
          "FC barrier", "head")

def _sum(i: int, indent: str) -> str:
    return f"{indent}{{ const long long c = clock64(); cyc[{i}] += c - c0; c0 = c; }}\n"


_BARRIER = "      rtvc::grid_barrier(s.sync, ctas * ++barriers);\n"
_ELEMENTWISE_END = "          __syncthreads();\n        }\n      }\n" + _BARRIER
# (text, the text with the clock's marks): thread 0 of every CTA reads the
# clock at each phase's end; CTA 0 writes its sums into the first samples
# once the loop ends (the eighth: the whole loop). The first _ELEMENTWISE_END
# is the GRUs', the second the FCs'.
CLOCK_MARKS = (
    ("  unsigned int barriers = 0;\n",
     "  unsigned int barriers = 0;\n"
     "  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c0 = clock64();\n"
     "  const long long c_loop = c0;\n"),
    ("          const float* hf = h_read + (size_t)f0 * R;\n",
     "          c0 = clock64();\n          const float* hf = h_read + (size_t)f0 * R;\n"),
    ("          __syncthreads();\n          for (int i = tid; i < pairs; i += kThreads) {",
     "          __syncthreads();\n" + _sum(0, " " * 10)
     + "          for (int i = tid; i < pairs; i += kThreads) {"),
    (_ELEMENTWISE_END, "          __syncthreads();\n" + _sum(1, " " * 10) + "        }\n      }\n"
     + _BARRIER + _sum(2, " " * 6)),
    ("          fc_product<NB>(smw + lay.fc_w[k]",
     "          c0 = clock64();\n          fc_product<NB>(smw + lay.fc_w[k]"),
    ("          __syncthreads();\n          if (!gumbel) {",
     "          __syncthreads();\n" + _sum(3, " " * 10) + "          if (!gumbel) {"),
    (_ELEMENTWISE_END, "          __syncthreads();\n" + _sum(4, " " * 10) + "        }\n      }\n"
     + _BARRIER + _sum(5, " " * 6)),
    ("    __syncthreads();\n  }\n}\n",
     "    __syncthreads();\n" + _sum(6, " " * 4) + "  }\n  if (cta == 0 && tid == 0) {\n"
     "    cyc[7] = clock64() - c_loop;\n    for (int i = 0; i < 8; ++i) out[i] = (float)cyc[i];\n"
     "  }\n}\n"),
)


def clocked(source: str) -> str:
    """The source with CTA 0's cycles a phase (``PHASES``) summed over the
    steps and written as floats into the first samples, the whole loop's
    eighth."""
    for old, new in CLOCK_MARKS:
        source = profile_lstm.replaced(source, old, new)
    return source


def profile_case(libs: dict, model_type: str, B: int, dev) -> None:
    voc = factories.init_voc_model(model_type, seed=0, device=dev)
    d, model = voc.dims, voc.model
    g = torch.Generator().manual_seed(2)
    mels_up = (torch.rand(B, STEPS, d.feat_dims, generator=g) * 2 - 1).to(dev)
    aux = (torch.randn(B, STEPS, d.res_out_dims, generator=g) * 0.5).to(dev)
    with torch.no_grad():
        streams = {k: v.contiguous() for k, v in wrn.hoist_aux(model, d, mels_up, aux).items()}
        w = wrn.step_weights(model, d)
    p = wg.plan(d.variant, d.rnn_dims, d.fc_dims, d.n_classes, B,
                *_build.device_limits(dev), head=d.head)
    print(f"{model_type} {d.mode}, {B} folds x {STEPS} steps: {p}")
    for name, lib in libs.items():
        run = lambda: wg.launch(lib, w, streams, 0, True, False, d.variant, d.head)  # noqa: E731
        if name == "clock":
            cyc = run().reshape(-1)[:8].double().cpu().tolist()
            print("  clock, cycles a step: " + ", ".join(
                f"{phase} {c / STEPS:.0f} ({100 * c / cyc[7]:.1f} %)"
                for phase, c in zip(PHASES, cyc)) + f"; the loop {cyc[7] / STEPS:.0f}")
            continue
        ms = profile_lstm.cuda_ms(run)
        print(f"  {name}: {ms:.3f} ms, {ms / STEPS * 1e3:.2f} us a step")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wavernn: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        source = profile_lstm.flat_source("wavernn_generate.cu")
        libs = profile_lstm.build(Path(tmp), {**variants(source), "clock": clocked(source)},
                                  ("rtvc_wavernn_generate",))
        for model_type, B in CASES:
            profile_case(libs, model_type, B, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
