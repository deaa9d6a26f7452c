"""The parameters of each reference model: names (the published state-dict
names), shapes from a configuration file's widths, and how each is drawn.

An entry is ``(name, shape, init)``; ``init`` is ``("u", bound)`` for
uniform in ±bound, ``("n", std)`` for a normal draw, or ``("c", value)`` for
a constant. Matrices of the synthesizers take Xavier-uniform bounds over
their last two axes, every other weight ±1/√fan_in, recurrent weights
±1/√hidden; BatchNorms start at identity; embeddings are N(0, 1).
"""
from __future__ import annotations

import math
from typing import List, Tuple

Spec = List[Tuple[str, tuple, tuple]]


def _fan(shape) -> tuple:
    n = 1
    for s in shape[1:]:
        n *= s
    return ("u", 1.0 / math.sqrt(n))


def _xavier(shape) -> tuple:
    return ("u", math.sqrt(6.0 / (shape[-1] + shape[-2])))


class _Builder:
    def __init__(self, xavier: bool):
        self.spec: Spec = []
        self.xavier = xavier

    def add(self, name, shape, init=None):
        shape = tuple(shape)
        if init is None:
            init = _xavier(shape) if self.xavier and len(shape) > 1 else _fan(shape)
        self.spec.append((name, shape, init))

    def linear(self, p, n_in, n_out, bias=True):
        self.add(p + "weight", (n_out, n_in))
        if bias:
            self.add(p + "bias", (n_out,), _fan((n_out, n_in)))

    def conv(self, p, n_in, n_out, k, bias=True):
        self.add(p + "weight", (n_out, n_in, k))
        if bias:
            self.add(p + "bias", (n_out,), _fan((n_out, n_in, k)))

    def bn(self, p, n):
        self.add(p + "weight", (n,), ("c", 1.0))
        self.add(p + "bias", (n,), ("c", 0.0))
        self.add(p + "running_mean", (n,), ("c", 0.0))
        self.add(p + "running_var", (n,), ("c", 1.0))

    def recurrent(self, p, n_in, H, gates, sfxs=("",)):
        rec = ("u", 1.0 / math.sqrt(H))
        for sfx in sfxs:
            for name, shape in (("weight_ih", (gates * H, n_in)), ("weight_hh", (gates * H, H)),
                                ("bias_ih", (gates * H,)), ("bias_hh", (gates * H,))):
                self.add(f"{p}{name}_l0{sfx}", shape,
                         _xavier(shape) if self.xavier and len(shape) > 1 else rec)

    def bn_conv(self, p, n_in, n_out, k):
        self.conv(p + "conv.", n_in, n_out, k, bias=False)
        self.bn(p + "bnorm.", n_out)

    def cbhg(self, p, K, n_in, channels, proj, highways, forward_variant=False):
        for k in range(1, K + 1):
            self.bn_conv(f"{p}conv1d_bank.{k - 1}.", n_in, channels, k)
        self.bn_conv(p + "conv_project1.", K * channels, proj[0], 3)
        self.bn_conv(p + "conv_project2.", proj[0], proj[1], 3)
        if forward_variant or proj[-1] != channels:
            self.linear(p + "pre_highway.", proj[-1], channels, bias=False)
        for i in range(highways):
            self.linear(f"{p}highways.{i}.W1.", channels, channels)
            self.linear(f"{p}highways.{i}.W2.", channels, channels)
        H = channels if forward_variant else channels // 2
        self.recurrent(p + "rnn.", channels, H, 3, ("", "_reverse"))


def encoder_spec(c: dict) -> Spec:
    """GE2E speaker encoder: ``n_layers`` LSTMs, a linear layer, the
    similarity scale (w 10, b -5)."""
    b = _Builder(xavier=False)
    H = c["hidden"]
    rec = ("u", 1.0 / math.sqrt(H))
    for k in range(c["layers"]):
        n_in = c["mel_channels"] if k == 0 else H
        for name, shape in ((f"weight_ih_l{k}", (4 * H, n_in)), (f"weight_hh_l{k}", (4 * H, H)),
                            (f"bias_ih_l{k}", (4 * H,)), (f"bias_hh_l{k}", (4 * H,))):
            b.add("lstm." + name, shape, rec)
    b.linear("linear.", H, c["embedding"])
    b.add("similarity_weight", (1,), ("c", 10.0))
    b.add("similarity_bias", (1,), ("c", -5.0))
    return b.spec


def tacotron_spec(c: dict) -> Spec:
    b = _Builder(xavier=True)
    E = c["encoder_dims"] + c["speaker_embedding_size"]
    D, L, M = c["decoder_dims"], c["lstm_dims"], c["n_mels"]
    b.add("encoder.embedding.weight", (c["num_chars"], c["embed_dims"]))
    b.linear("encoder.pre_net.fc1.", c["embed_dims"], c["encoder_dims"])
    b.linear("encoder.pre_net.fc2.", c["encoder_dims"], c["encoder_dims"])
    b.cbhg("encoder.cbhg.", c["encoder_K"], c["encoder_dims"], c["encoder_dims"],
           (c["encoder_dims"], c["encoder_dims"]), c["num_highways"])
    b.linear("encoder_proj.", E, D, bias=False)
    b.linear("decoder.prenet.fc1.", M, 2 * D)
    b.linear("decoder.prenet.fc2.", 2 * D, 2 * D)
    b.conv("decoder.attn_net.conv.", 1, 32, 31)
    b.linear("decoder.attn_net.L.", 32, D, bias=False)
    b.linear("decoder.attn_net.W.", D, D)
    b.linear("decoder.attn_net.v.", D, 1, bias=False)
    rec = ("u", 1.0 / math.sqrt(D))
    for name, shape in (("weight_ih", (3 * D, E + 2 * D)), ("weight_hh", (3 * D, D)),
                        ("bias_ih", (3 * D,)), ("bias_hh", (3 * D,))):
        b.add("decoder.attn_rnn." + name, shape, None if len(shape) > 1 else rec)
    b.linear("decoder.rnn_input.", E + D, L)
    for cell in ("res_rnn1", "res_rnn2"):
        rec = ("u", 1.0 / math.sqrt(L))
        for name, shape in (("weight_ih", (4 * L, L)), ("weight_hh", (4 * L, L)),
                            ("bias_ih", (4 * L,)), ("bias_hh", (4 * L,))):
            b.add(f"decoder.{cell}.{name}", shape, None if len(shape) > 1 else rec)
    b.linear("decoder.mel_proj.", L, M * c["max_r"], bias=False)
    b.linear("decoder.stop_proj.", L + E, 1)
    b.cbhg("postnet.", c["postnet_K"], M, c["postnet_dims"], (c["postnet_dims"], M),
           c["num_highways"])
    b.linear("post_proj.", c["postnet_dims"], M, bias=False)
    return b.spec


def forward_tacotron_spec(c: dict) -> Spec:
    b = _Builder(xavier=True)
    spk, M = c["speaker_embedding_size"], c["n_mels"]
    for name in ("duration", "pitch", "energy"):
        p = {"duration": "dur_pred.", "pitch": "pitch_pred.", "energy": "energy_pred."}[name]
        conv, rnn = c[f"{name}_conv_dims"], c[f"{name}_rnn_dims"]
        b.add(p + "embedding.weight", (c["num_chars"], c["series_embed_dims"]))
        for i in range(3):
            b.bn_conv(f"{p}convs.{i}.", c["series_embed_dims"] + spk if i == 0 else conv, conv, 5)
        b.recurrent(p + "rnn.", conv, rnn, 3, ("", "_reverse"))
        b.linear(p + "lin.", 2 * rnn, 1)
    b.add("embedding.weight", (c["num_chars"], c["embed_dims"]))
    P = c["prenet_dims"]
    b.cbhg("prenet.", c["prenet_k"], c["embed_dims"], P, (P, c["embed_dims"]),
           c["prenet_num_highways"], forward_variant=True)
    b.recurrent("lstm.", 2 * P + spk, c["rnn_dims"], 4, ("", "_reverse"))
    b.linear("lin.", 2 * c["rnn_dims"], M)
    Q = c["postnet_dims"]
    b.cbhg("postnet.", c["postnet_k"], M, Q, (Q, M), c["postnet_num_highways"],
           forward_variant=True)
    b.linear("post_proj.", 2 * Q, M, bias=False)
    b.conv("pitch_proj.", 1, 2 * P, 3)
    b.conv("energy_proj.", 1, 2 * P, 3)
    # every character takes ``frames_per_char`` frames (see the configuration)
    b.spec = [(n, s, ("c", 0.0) if n == "dur_pred.lin.weight" else
               ("c", float(c["frames_per_char"])) if n == "dur_pred.lin.bias" else i)
              for n, s, i in b.spec]
    return b.spec


def wavernn_spec(c: dict) -> Spec:
    """The runtimeracer WaveRNN (RAW head): upsampler, ``I``, four GRUs, five
    FCs; the smoothing convs start as moving averages."""
    b = _Builder(xavier=False)
    R, Fd, Cd = c["rnn_dims"], c["fc_dims"], c["compute_dims"]
    Ro, M = c["res_out_dims"], c["n_mels"]
    A = Ro // 4
    b.conv("upsample.resnet.conv_in.", M, Cd, 2 * c["pad"] + 1, bias=False)
    b.bn("upsample.resnet.batch_norm.", Cd)
    for i in range(c["res_blocks"]):
        b.conv(f"upsample.resnet.layers.{i}.conv1.", Cd, Cd, 1, bias=False)
        b.conv(f"upsample.resnet.layers.{i}.conv2.", Cd, Cd, 1, bias=False)
        b.bn(f"upsample.resnet.layers.{i}.batch_norm1.", Cd)
        b.bn(f"upsample.resnet.layers.{i}.batch_norm2.", Cd)
    b.conv("upsample.resnet.conv_out.", Cd, Ro, 1)
    for i, s in enumerate(c["upsample_factors"]):
        b.add(f"upsample.up_layers.{2 * i + 1}.weight", (1, 1, 1, 2 * s + 1),
              ("c", 1.0 / (2 * s + 1)))
    b.linear("I.", M + A, R)
    for k in range(1, 5):
        b.recurrent(f"rnn{k}.", R + A if k == 3 else R, R, 3)
    n_in = R
    for k in range(1, 6):
        n_out = 2 ** c["bits"] if k == 5 else Fd
        b.linear(f"fc{k}.", n_in + A if k in (1, 3) else n_in, n_out)
        n_in = n_out
    return b.spec
