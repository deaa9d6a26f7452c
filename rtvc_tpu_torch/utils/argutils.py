"""CLI argument pretty-printing (a copy of ``rtvc_tpu/utils/argutils.py``,
held equal in source by ``tests/test_torch_imports.py``; capability parity
with the reference's ``utils/argutils.py``)."""
from __future__ import annotations

import argparse
from pathlib import Path

_PRIORITY = {Path: 0, str: 1, int: 2, float: 3, bool: 4}


def print_args(args: argparse.Namespace, parser: argparse.ArgumentParser = None):
    """Print parsed arguments grouped by type, aligned."""
    items = sorted(
        vars(args).items(),
        key=lambda kv: (_PRIORITY.get(type(kv[1]), 5), kv[0]),
    )
    width = max((len(k) for k, _ in items), default=0)
    title = "Arguments"
    if parser is not None and parser.prog:
        title += f" ({parser.prog})"
    print(title)
    print("-" * (width + 4))
    for k, v in items:
        print(f"  {k.ljust(width)}  {v}")
    print()
