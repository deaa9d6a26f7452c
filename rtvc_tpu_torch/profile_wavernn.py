"""Where K1's time goes, by taking parts of the sample loop away.

    python -m rtvc_tpu_torch.profile_wavernn

Builds ``csrc/wavernn_generate.cu`` (with ``common.cuh`` written into it) as
it is and in the variants of ``profile_gru``: the layers' inputs not read
from L2, the weights not read from shared memory, both, and the grid
barrier's wait taken out. Times each, greedy, with CUDA events through the
package's plan: runtimeracer RAW at 13 folds (a 5 s clone) and 264, fatchord
RAW and geneing BITS at 13 and at 20 (a 5 s clone at their 3000 / 1500
window), 512 steps each, with full-width seeded random weights. The variants' samples are wrong by construction; only their times
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

CASES = ((factories.MODEL_TYPE_RUNTIMERACER, 13), (factories.MODEL_TYPE_RUNTIMERACER, 264),
         (factories.MODEL_TYPE_FATCHORD, 13), (factories.MODEL_TYPE_FATCHORD, 20),
         (factories.MODEL_TYPE_GENEING, 13), (factories.MODEL_TYPE_GENEING, 20))
STEPS = 512


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
        ms = profile_lstm.cuda_ms(lambda: wg.launch(lib, w, streams, 0, True, False, d.variant,
                                                    d.head))
        print(f"  {name}: {ms:.3f} ms, {ms / STEPS * 1e3:.2f} us a step")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wavernn: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = profile_lstm.build(Path(tmp),
                                  variants(profile_lstm.flat_source("wavernn_generate.cu")),
                                  ("rtvc_wavernn_generate",))
        for model_type, B in CASES:
            profile_case(libs, model_type, B, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
