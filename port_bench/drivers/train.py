"""A trainer's step, back to back: the port's training step (model,
optimizer and generator in one closure) on a pool of seeded batches made on
the device, cycled. Reports the window's wall time over the steps it
completed (``train_step_ms``).

Set-up builds the one step object and drives it through its first
``check_steps`` steps (the warm-up), on batches of the pool whose rows all
differ; the window goes on from there with the same object. The check
follows those first steps with the plain reference from the same initial
weights, batches and random draws: each step's loss, the first step's
gradient as Adam holds it after one step, the parameters' change after the
last of them.

Traffic parameters: ``trainer`` (the step's kind, a key of ``TRAINERS``),
``lr``, ``pool``, ``check_steps``, and the trainer's batch:

* ``tacotron``: ``batch``, ``chars`` and ``frames`` (the padded batch), ``r``,
  ``clip`` (``train/steps.py:make_tacotron_train_step`` at f32);
* ``encoder``: ``speakers``, ``utterances`` and ``frames`` (the GE2E batch of
  speakers × utterances partials, ``make_encoder_train_step`` at f32).
"""
from __future__ import annotations

import traceback
from typing import Dict

import torch

from port_bench.counts import flops
from port_bench.harness import train_checks
from port_bench.harness.system import ENC, SYN, make_weights


def tacotron_batches(p: dict, cfg: dict, seed: int, device) -> list:
    """``pool`` batches as the synthesizer's collate makes them: chars (B, T)
    with zero-padded tails of 50-100 % of T, mels (B, n_mels, frames) smooth
    in time and across bins and mostly below zero, clipped to the symmetric
    range, unit speaker embeddings, stop targets from lengths of 50-100 % of
    the frames. Made on the device from the seed."""
    B, T, L = p["batch"], p["chars"], p["frames"]
    M, spk = cfg["synthesizer"]["n_mels"], cfg["synthesizer"]["speaker_embedding_size"]
    lim = cfg["signal"]["max_abs_value"]
    g = torch.Generator(device=device).manual_seed((seed * 7 + 5) % (2 ** 63))
    out = []
    for _ in range(p["pool"]):
        lens = torch.randint(T // 2, T + 1, (B,), generator=g, device=device)
        spec = torch.randint(L // 2, L, (B,), generator=g, device=device)
        ids = torch.randint(1, 60, (B, T), generator=g, device=device)
        chars = torch.where(torch.arange(T, device=device)[None] < lens[:, None], ids, 0)
        t = torch.arange(L, device=device)[None, None, :].float()
        m = torch.arange(M, device=device)[None, :, None].float()
        phase = torch.rand((B, 1, 1), generator=g, device=device) * 6.3
        mels = (-1.5 + 2 * torch.sin(2 * torch.pi * (t / 97 + m / 40) + phase)
                + 0.3 * torch.randn((B, M, L), generator=g, device=device)).clamp(-lim, lim)
        e = torch.randn((B, spk), generator=g, device=device)
        stop = (torch.arange(L, device=device)[None] >= spec[:, None] - 1).float()
        out.append({"chars": chars.to(torch.int32), "mels": mels,
                    "embeds": e / torch.linalg.norm(e, dim=1, keepdim=True), "stop": stop})
    return out


def encoder_batches(p: dict, cfg: dict, seed: int, device) -> list:
    """``pool`` GE2E batches (speakers × utterances, frames, mel channels),
    speaker-major as the encoder's loader stacks them: log-mel-like frames
    in [0, 1], each speaker a spectral tilt of its own, each utterance a
    phase and noise of its own. Made on the device from the seed."""
    S, U, T = p["speakers"], p["utterances"], p["frames"]
    M = cfg["encoder"]["mel_channels"]
    g = torch.Generator(device=device).manual_seed((seed * 7 + 5) % (2 ** 63))
    t = torch.arange(T, device=device)[None, None, :, None].float()
    m = torch.arange(M, device=device)[None, None, None, :].float()
    out = []
    for _ in range(p["pool"]):
        tilt = torch.rand((S, 1, 1, 1), generator=g, device=device)
        phase = torch.rand((S, U, 1, 1), generator=g, device=device) * 6.3
        x = (0.45 + 0.25 * tilt * (1 - m / M) + 0.2 * torch.sin(2 * torch.pi * (t / 31 + m / 9)
                                                                 + phase)
             + 0.05 * torch.randn((S, U, T, M), generator=g, device=device)).clamp(0, 1)
        out.append({"inputs": x.reshape(S * U, T, M)})
    return out


class Tacotron:
    weights = SYN
    batches = staticmethod(tacotron_batches)

    @staticmethod
    def build(run, W, generator):
        from rtvc_tpu_torch.models import factories
        from rtvc_tpu_torch.train import steps, trainer

        p, syn = run.traffic, run.config["synthesizer"]
        base = factories.default_config("tacotron")
        tcfg = base.replace(**{k: v for k, v in syn.items() if hasattr(base, k)})
        dims = factories.syn_dims("tacotron", tcfg)
        model = factories.empty_on_device(lambda: factories.Tacotron(dims), run.device)
        model.load_state_dict(W, strict=True)
        model.train()
        opt = trainer.make_optimizer(model.parameters(), p["lr"])
        raw = steps.make_tacotron_train_step(model, dims, opt, p["r"], p["clip"], "f32")
        return model, opt, lambda b: raw(b, generator)[0]["loss"]

    @staticmethod
    def step_flops(run) -> float:
        p = run.traffic
        return flops.tacotron_train_step(run.config["synthesizer"], p["batch"], p["chars"],
                                         p["frames"], p["r"])

    @staticmethod
    def counters(run) -> dict:
        p = run.traffic
        return {"k5": (p["batch"], p["frames"] // p["r"], p["chars"])}


class Encoder:
    weights = ENC
    batches = staticmethod(encoder_batches)

    @staticmethod
    def build(run, W, generator):
        from rtvc_tpu_torch.config.encoder import EncoderModelParams
        from rtvc_tpu_torch.models import factories
        from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
        from rtvc_tpu_torch.train import steps, trainer

        p, e = run.traffic, run.config["encoder"]
        hp = EncoderModelParams(model_hidden_size=e["hidden"], model_embedding_size=e["embedding"],
                                model_num_layers=e["layers"])
        model = factories.empty_on_device(lambda: SpeakerEncoder(hp), run.device)
        model.load_state_dict(W, strict=True)
        model.train()
        opt = trainer.make_optimizer(model.parameters(), p["lr"])
        raw = steps.make_encoder_train_step(model, opt, p["speakers"], p["utterances"], "f32")
        return model, opt, lambda b: raw(b["inputs"])[0]

    @staticmethod
    def step_flops(run) -> float:
        p = run.traffic
        return 3 * flops.encoder(run.config["encoder"], p["speakers"] * p["utterances"],
                                 p["frames"])

    @staticmethod
    def counters(run) -> dict:
        return {}


TRAINERS = {"tacotron": Tacotron, "encoder": Encoder}


def trainer_of(run):
    name = run.traffic["trainer"]
    if name not in TRAINERS:
        raise ValueError(f"no trainer {name!r} in this driver (it has {sorted(TRAINERS)})")
    return TRAINERS[name]


def setup(run):
    p, cfg = run.traffic, run.config
    kind = trainer_of(run)
    W = make_weights(cfg, run.seed, run.device)[kind.weights]
    run.mark("weights made")
    gen_seed = (run.seed * 11 + 3) % (2 ** 63)
    generator = torch.Generator(device=run.device).manual_seed(gen_seed)
    model, opt, step = kind.build(run, W, generator)
    batches = kind.batches(p, cfg, run.seed, run.device)
    run.mark("step built, batches made")

    names = [n for n, q in model.named_parameters() if q.requires_grad]
    params = dict(model.named_parameters())
    losses, grad1 = [], {}
    for k in range(int(p["check_steps"])):
        losses.append(float(step(batches[k % len(batches)])))
        if k == 0:  # the gradient as Adam holds it after one step: exp_avg / (1 - β1)
            grad1 = {n: float(torch.linalg.norm(opt.state[params[n]]["exp_avg"] / 0.1))
                     if "exp_avg" in opt.state.get(params[n], {}) else 0.0 for n in names}
    delta = {n: float(torch.linalg.norm(params[n].detach() - W[n])) for n in names}
    run.sync()
    run.mark("first steps taken")
    return {"step": step, "batches": batches, "model": model, "opt": opt, "W": W,
            "losses": losses, "grad1": grad1, "delta": delta, "gen_seed": gen_seed,
            "steps": 0, "next": int(p["check_steps"])}


def window(run, st) -> None:
    step, batches = st["step"], st["batches"]
    loss = None
    while not run.deadline_passed():
        run.attempted += 1
        try:
            with run.span("step"):
                loss = step(batches[st["next"] % len(batches)])
        except Exception:  # a step that fails counts, and the run goes on
            run.failed += 1
            traceback.print_exc()
            continue
        st["next"] += 1
        st["steps"] += 1
    run.sync()
    if loss is not None and not bool(torch.isfinite(loss)):
        run.failed += 1


def end_to_end(run, st) -> Dict[str, float]:
    kind = trainer_of(run)
    run.counters["steps"] = st["steps"]
    run.counters["model_flops"] = st["steps"] * kind.step_flops(run)
    run.counters.update(kind.counters(run))
    return {"train_step_ms": run.window_s * 1e3 / max(st["steps"], 1)}


def release(run, st) -> dict:
    keep = {k: st[k] for k in ("W", "losses", "grad1", "delta", "gen_seed", "batches")}
    st.clear()
    return keep


def items(run, record) -> list:
    return [record]


def numbers(run, record, item, stages=None) -> dict:
    if "_ref" not in record:  # the reference's steps, taken once a record
        record["_ref"] = train_checks.reference_item(run, record, "f32")
    return train_checks.numbers(run, item, record["_ref"])


def faults(run) -> dict:
    """The training faults, planted in the reference put in the program's
    place: half of each batch left out (the mean over the rest); a step that
    returns its state unchanged."""
    return {"half_batch": (lambda it: train_checks.reference_item(run, it, "f32", half=True),
                           None),
            "state_unchanged": (lambda it: {**it, "delta": {n: 0.0 for n in it["delta"]}},
                                None)}


def control_item(run, record, item) -> dict:
    """The first steps taken by the reference at TF32 in the program's
    place."""
    return train_checks.reference_item(run, item, "tf32")


def check(run, record) -> None:
    for k, v in numbers(run, record, record).items():
        run.check(k, v)
