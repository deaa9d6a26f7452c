"""The numbers that decide ``correct`` for a training cell: the plain
reference follows the program's first steps from the same initial weights,
batches and random draws.

* ``loss_err``: each step's loss, the largest relative gap;
* ``grad1_err``: the first step's gradient as the optimizer got it (after
  the clip), leaf by leaf: the gap between the program's norm and the
  reference's over the larger of the reference's norm of that leaf and of
  the median leaf, the worst leaf;
* ``delta_err``: the parameters' change after the last checked step, by the
  same measure, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (leaves with no gradient to speak of move
  under Adam by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

from port_bench.reference import encoder as ref_enc
from port_bench.reference import tacotron as ref_taco
from port_bench.reference.encoder import Adam
from port_bench.reference.nn import Prec

EXCLUDE_BELOW = 1e-3


def reference_item(run, record: dict, mode: str = "f32", half: bool = False) -> dict:
    """The first ``check_steps`` steps taken by the reference at ``mode``
    (with ``half``, on the first half of each batch's rows only: for the
    encoder, its first half of the speakers) → the same keys as the
    program's record."""
    p = run.traffic
    P = Prec(mode)
    W0 = record["W"]
    W = {k: v.detach().clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in W0.items()}
    leaves = [k for k, v in W.items() if v.requires_grad]
    opt = Adam(p["lr"])
    gen = torch.Generator(device=next(iter(W0.values())).device).manual_seed(record["gen_seed"])
    losses, grad1 = [], {}
    for k in range(int(p["check_steps"])):
        batch = record["batches"][k % len(record["batches"])]
        if p["trainer"] == "encoder":
            S, U = p["speakers"], p["utterances"]
            x = batch["inputs"]
            if half:
                S, x = S // 2, x[:S // 2 * U]
            loss, grads = ref_enc.encoder_train_step(P, W, run.config["encoder"], opt, x, S, U)
            losses.append(loss)
        else:
            loss, grads = _tacotron_step(P, W, leaves, run, batch, gen, half)
            opt.step(W, grads)
            losses.append(float(loss.detach()))
        if k == 0:
            grad1 = {n: float(torch.linalg.norm(g)) for n, g in grads.items()}
    delta = {n: float(torch.linalg.norm(W[n].detach() - W0[n])) for n in leaves}
    return {**record, "losses": losses, "grad1": grad1, "delta": delta}


def _tacotron_step(P: Prec, W, leaves, run, batch: dict, gen, half: bool):
    """One Tacotron step's loss and its gradients after the global-norm clip."""
    p, c = run.traffic, run.config["synthesizer"]
    if half:
        batch = {n: t[:t.shape[0] // 2] for n, t in batch.items()}
    m1, m2, stop, _ = ref_taco.train_forward(P, W, c, batch, p["r"], gen)
    loss = ref_taco.loss(m1, m2, stop, batch["mels"], batch["stop"])
    grads = torch.autograd.grad(loss, [W[n] for n in leaves])
    with torch.no_grad():
        norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
        scale = torch.clamp(p["clip"] / (norm + 1e-6), max=1.0)
        return loss, {n: g * scale for n, g in zip(leaves, grads)}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    names = [n for n in ref if keep is None or n in keep]
    if not names or set(names) - set(prog):
        return 1e30
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def numbers(run, item: dict, ref: dict = None) -> Dict[str, float]:
    """``item``: the program's record (or a control's); ``ref``: the
    reference's steps (taken here at float32 unless given)."""
    if ref is None:
        ref = reference_item(run, item, "f32")
    if len(item["losses"]) != len(ref["losses"]):
        return {"loss_err": 1e30, "grad1_err": 1e30, "delta_err": 1e30}
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(item["losses"], ref["losses"]))
    med = statistics.median(ref["grad1"].values())
    moving = {n for n, g in ref["grad1"].items() if g >= EXCLUDE_BELOW * med}
    return {"loss_err": loss_err, "grad1_err": _worst_leaf(item["grad1"], ref["grad1"]),
            "delta_err": _worst_leaf(item["delta"], ref["delta"], moving)}
