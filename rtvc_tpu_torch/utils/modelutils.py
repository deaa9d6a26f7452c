"""Guidance for missing checkpoints (counterpart of
``rtvc_tpu/utils/modelutils.py``).

No trained weights ship with the port, so the guidance is how to train each
stage with the port's own entry points, or how to run the random-weight
self-test. ``demo_cli`` and ``serve`` use it, so a fresh install fails with
instructions, not a stack trace.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

_STAGE_HELP = {
    "encoder": "python -m rtvc_tpu_torch.encoder_train my_run "
               "<datasets_root>/SV2TTS/encoder",
    "synthesizer": "python -m rtvc_tpu_torch.synthesizer_train my_run tacotron "
                   "<datasets_root>/SV2TTS/synthesizer",
    "vocoder": "python -m rtvc_tpu_torch.vocoder_train my_run runtimeracer-wavernn "
               "<datasets_root>",
}


def missing_models(encoder_path: Path, synthesizer_path: Path,
                   vocoder_path: Path) -> Dict[str, Path]:
    """Stage name → path for every checkpoint path that does not exist."""
    paths = {"encoder": Path(encoder_path), "synthesizer": Path(synthesizer_path),
             "vocoder": Path(vocoder_path)}
    return {name: p for name, p in paths.items() if not (p.is_file() or p.is_dir())}


def model_files_missing(missing: Optional[Dict[str, Path]] = None,
                        type: Optional[str] = None) -> None:
    """Print what is missing and how to train each missing stage."""
    bar = "*" * 80
    print(bar)
    if type is not None:
        print(f"Error: {type} model files not found.")
    elif missing:
        print("Error: model files not found for: " + ", ".join(missing))
    else:
        print("Error: model files not found.")
    for name, p in (missing or {}).items():
        print(f"  {name}: expected a checkpoint at {p}")
    print("\nTo obtain models, train each stage (each trainer writes "
          "saved_models/<run_id>/<run_id>.pt):")
    for name, cmd in _STAGE_HELP.items():
        if missing is None or name in missing:
            print(f"  {name}:\n    {cmd}")
    print("\nOr run `python -m rtvc_tpu_torch.demo_cli --selftest` to exercise the full "
          "pipeline\nwith random weights (no checkpoints needed).")
    print(bar + "\n")


def check_model_paths(
    encoder_path: Path, synthesizer_path: Path, vocoder_path: Path
) -> List[str]:
    """Validate the three stage checkpoints; print guidance and raise
    ``SystemExit`` when NONE exist (the reference's contract,
    ref: utils/modelutils.py:3-14). Returns the names of individually
    missing stages so callers can warn on partial installs."""
    missing = missing_models(encoder_path, synthesizer_path, vocoder_path)
    if len(missing) == 3:
        model_files_missing(missing)
        raise SystemExit(-1)
    return list(missing)
