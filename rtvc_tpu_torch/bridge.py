"""JAX variables → state_dicts of this package's modules.

The inverse of the JAX package's ``import_torch_state`` functions
(``models/speaker_encoder.py``, ``models/tacotron.py``, ``models/wavernn.py``,
``models/forward_tacotron.py``, ``models/fast_pitch.py``):
the input is a variables tree as nested dicts (and lists) of arrays — numpy,
anything ``np.asarray`` accepts, or torch tensors — and the output is a
state_dict under the reference's torch names, which the port's modules load
with ``load_state_dict(strict=True)``. No JAX import is needed.

The same functions map a JAX gradient tree (``jax.grad`` of a training
loss over the same variables) to the names of the port's parameters, so a
test can compare gradients name by name: the encoder's takes the training
step's ``{"model", "similarity"}`` layout, and Tacotron's and the WaveRNN's
a tree without ``batch_stats``. The way back, a state_dict → JAX variables,
is the JAX package's own ``import_torch_state``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a bfloat16 leaf of a .ckpt
        return x.detach().to(dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _put(sd: StateDict, prefix: str, tree: Mapping) -> None:
    """Copy a flat {name: array} dict under ``prefix``."""
    for name, v in tree.items():
        sd[prefix + name] = _t(v)


def speaker_encoder_state(variables: Mapping) -> StateDict:
    """{"params": {"lstm", "linear"}, optional "similarity"} → SpeakerEncoder
    state_dict. The GE2E scale defaults to the reference's w=10, b=-5. The
    training step's layout, {"model": {"lstm", "linear"}, "similarity"}, maps
    the same way."""
    p = variables["params"] if "params" in variables else variables["model"]
    sd: StateDict = OrderedDict()
    _put(sd, "lstm.", p["lstm"])
    _put(sd, "linear.", p["linear"])
    sim = variables.get("similarity") or {}
    sd["similarity_weight"] = _t(sim.get("similarity_weight", [10.0]))
    sd["similarity_bias"] = _t(sim.get("similarity_bias", [-5.0]))
    return sd


def _cbhg(sd: StateDict, prefix: str, params: Mapping, stats: Optional[Mapping]) -> None:
    for name, p in params.items():
        if name.startswith(("conv1d_bank_", "conv_project")):
            torch_name = (f"conv1d_bank.{name.rsplit('_', 1)[1]}"
                          if name.startswith("conv1d_bank_") else name)
            sd[f"{prefix}{torch_name}.conv.weight"] = _t(p["conv"]["weight"])
            _put(sd, f"{prefix}{torch_name}.bnorm.", p["bnorm"])
            if stats is not None:
                _put(sd, f"{prefix}{torch_name}.bnorm.", stats[name]["bnorm"])
        elif name == "pre_highway":
            _put(sd, f"{prefix}pre_highway.", p)
        elif name.startswith("highways_"):
            i = name.rsplit("_", 1)[1]
            _put(sd, f"{prefix}highways.{i}.W1.", p["W1"])
            _put(sd, f"{prefix}highways.{i}.W2.", p["W2"])
        elif name == "rnn":
            _put(sd, f"{prefix}rnn.", p)
        else:
            raise KeyError(f"unexpected CBHG entry {name!r}")


def tacotron_state(variables: Mapping) -> StateDict:
    """{"params", "batch_stats"} (``init_tacotron`` layout) → Tacotron
    state_dict. Without "batch_stats" (a gradient tree) only the parameters
    are mapped."""
    p = variables["params"]
    s = variables.get("batch_stats") or {"enc_cbhg": None, "postnet": None}
    sd: StateDict = OrderedDict()
    _put(sd, "encoder.embedding.", p["embedding"])
    for fc in ("fc1", "fc2"):
        _put(sd, f"encoder.pre_net.{fc}.", p["enc_prenet"][fc])
    _cbhg(sd, "encoder.cbhg.", p["enc_cbhg"], s["enc_cbhg"])
    _put(sd, "encoder_proj.", p["encoder_proj"])
    for fc in ("fc1", "fc2"):
        _put(sd, f"decoder.prenet.{fc}.", p["dec_prenet"][fc])
    _put(sd, "decoder.attn_net.conv.", p["lsa_conv"])
    _put(sd, "decoder.attn_net.L.", p["lsa_L"])
    _put(sd, "decoder.attn_net.W.", p["lsa_W"])
    _put(sd, "decoder.attn_net.v.", p["lsa_v"])
    _put(sd, "decoder.attn_rnn.", p["attn_rnn"])
    _put(sd, "decoder.rnn_input.", p["rnn_input"])
    _put(sd, "decoder.res_rnn1.", p["res_rnn1"])
    _put(sd, "decoder.res_rnn2.", p["res_rnn2"])
    _put(sd, "decoder.mel_proj.", p["mel_proj"])
    _put(sd, "decoder.stop_proj.", p["stop_proj"])
    _cbhg(sd, "postnet.", p["postnet"], s["postnet"])
    _put(sd, "post_proj.", p["post_proj"])
    return sd


def wavernn_state(variables: Mapping) -> StateDict:
    """{"params", "batch_stats"} (``init_wavernn`` layout, any variant) →
    WaveRNN state_dict: the upsampler, ``I``, and whichever of ``rnn1``-
    ``rnn4`` and ``fc1``-``fc5`` the variant has. Without "batch_stats" (a
    gradient tree) only the parameters are mapped."""
    p = variables["params"]
    up = p["upsample"]
    rp = up["resnet"]
    rs = variables["batch_stats"]["upsample"]["resnet"] if "batch_stats" in variables else None
    sd: StateDict = OrderedDict()
    pre = "upsample.resnet."
    sd[pre + "conv_in.weight"] = _t(rp["conv_in"]["weight"])
    _put(sd, pre + "batch_norm.", rp["batch_norm"])
    if rs is not None:
        _put(sd, pre + "batch_norm.", rs["batch_norm"])
    for i, lp in enumerate(rp["layers"]):
        lpre = f"{pre}layers.{i}."
        sd[lpre + "conv1.weight"] = _t(lp["conv1"]["weight"])
        sd[lpre + "conv2.weight"] = _t(lp["conv2"]["weight"])
        for bn in ("batch_norm1", "batch_norm2"):
            _put(sd, f"{lpre}{bn}.", lp[bn])
            if rs is not None:
                _put(sd, f"{lpre}{bn}.", rs["layers"][i][bn])
    _put(sd, pre + "conv_out.", rp["conv_out"])
    for i, w in enumerate(up["up_convs"]):
        sd[f"upsample.up_layers.{2 * i + 1}.weight"] = _t(w)
    for name in ("I", "rnn1", "rnn2", "rnn3", "rnn4", "fc1", "fc2", "fc3", "fc4", "fc5"):
        if name in p:
            _put(sd, f"{name}.", p[name])
    return sd


def forward_tacotron_state(variables: Mapping) -> StateDict:
    """{"params", "batch_stats"} (``init_forward_tacotron`` layout) →
    ForwardTacotron state_dict. Without "batch_stats" only the parameters
    are mapped."""
    p = variables["params"]
    s = variables.get("batch_stats")
    sd: StateDict = OrderedDict()
    for name in ("dur_pred", "pitch_pred", "energy_pred"):
        sp = p[name]
        _put(sd, f"{name}.embedding.", sp["embedding"])
        for i in range(3):
            conv = sp[f"convs_{i}"]
            sd[f"{name}.convs.{i}.conv.weight"] = _t(conv["conv"]["weight"])
            _put(sd, f"{name}.convs.{i}.bnorm.", conv["bnorm"])
            if s is not None:
                _put(sd, f"{name}.convs.{i}.bnorm.", s[name][f"convs_{i}"]["bnorm"])
        _put(sd, f"{name}.rnn.", sp["rnn"])
        _put(sd, f"{name}.lin.", sp["lin"])
    _put(sd, "embedding.", p["embedding"])
    _cbhg(sd, "prenet.", p["prenet"], None if s is None else s["prenet"])
    _put(sd, "lstm.", p["lstm"])
    _put(sd, "lin.", p["lin"])
    _cbhg(sd, "postnet.", p["postnet"], None if s is None else s["postnet"])
    _put(sd, "post_proj.", p["post_proj"])
    _put(sd, "pitch_proj.", p["pitch_proj"])
    _put(sd, "energy_proj.", p["energy_proj"])
    return sd


def _transformer(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + "pos_encoder.scale"] = _t(p["pos_encoder"]["scale"])
    n_layers = sum(1 for k in p if k.startswith("layers_"))
    for i in range(n_layers):
        lp, pre = p[f"layers_{i}"], f"{prefix}layers.{i}."
        attn = lp["self_attn"]
        sd[pre + "self_attn.in_proj_weight"] = _t(attn["in_proj_weight"])
        sd[pre + "self_attn.in_proj_bias"] = _t(attn["in_proj_bias"])
        _put(sd, pre + "self_attn.out_proj.", attn["out_proj"])
        for name in ("conv1", "conv2", "norm1", "norm2"):
            _put(sd, f"{pre}{name}.", lp[name])
    _put(sd, prefix + "norm.", p["norm"])


def fast_pitch_state(variables: Mapping) -> StateDict:
    """{"params"} (``init_fast_pitch`` layout; FastPitch has no running
    statistics) → FastPitch state_dict, the speaker projections
    ``spk_proj`` included."""
    p = variables["params"]
    sd: StateDict = OrderedDict()
    for name in ("dur_pred", "pitch_pred", "energy_pred"):
        sp = p[name]
        _put(sd, f"{name}.embedding.", sp["embedding"])
        _put(sd, f"{name}.spk_proj.", sp["spk_proj"])
        _transformer(sd, f"{name}.transformer.", sp["transformer"])
        _put(sd, f"{name}.lin.", sp["lin"])
    _put(sd, "embedding.", p["embedding"])
    _put(sd, "spk_proj.", p["spk_proj"])
    _transformer(sd, "prenet.", p["prenet"])
    _transformer(sd, "postnet.", p["postnet"])
    for name in ("lin", "pitch_proj", "energy_proj"):
        _put(sd, f"{name}.", p[name])
    return sd
