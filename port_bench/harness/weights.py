"""Seeded weights from a parameter spec (``reference.params``), made on the
device in two calls of one generator: one uniform draw for every uniform
leaf, one normal draw for every normal leaf; constants are filled."""
from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference.params import Spec


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    sizes = {"u": 0, "n": 0}
    for _, shape, (kind, _) in spec:
        if kind in sizes:
            sizes[kind] += int(torch.Size(shape).numel())
    pools = {"u": torch.rand(sizes["u"], generator=g, device=device),
             "n": torch.randn(sizes["n"], generator=g, device=device)}
    at = {"u": 0, "n": 0}
    out: Dict[str, torch.Tensor] = {}
    for name, shape, (kind, arg) in spec:
        n = int(torch.Size(shape).numel())
        if kind == "u":
            out[name] = (pools["u"][at["u"]:at["u"] + n].view(shape) * 2.0 - 1.0) * arg
        elif kind == "n":
            out[name] = pools["n"][at["n"]:at["n"] + n].view(shape) * arg
        elif kind == "c":
            out[name] = torch.full(shape, float(arg), device=device)
        else:
            raise ValueError(f"unknown init {kind!r} for {name}")
        if kind in at:
            at[kind] += n
    return out

