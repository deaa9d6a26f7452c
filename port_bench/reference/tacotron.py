"""Plain Tacotron of the SV2TTS fork: encoder (embedding → pre-net → CBHG,
the speaker embedding beside every character), the decoder iteration
(pre-net → attention GRU → location-sensitive attention → two residual
LSTMs → r frames and a stop token), the postnet (CBHG → projection), and the
teacher-forced training pass with its loss.

``W`` is a flat dict under the published state-dict names
(``params.tacotron_spec``); ``c`` a configuration's ``tacotron`` block.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from port_bench.reference.nn import (
    Prec,
    Weights,
    cbhg,
    conv_seq,
    dropout,
    gru_cell,
    lstm_cell,
)

Tensor = torch.Tensor

ZONEOUT_P = 0.1


def prenet(P: Prec, W: Weights, p: str, x: Tensor, rate: float,
           draws: Optional[Sequence[Tensor]] = None) -> Tensor:
    """Two ReLU layers; with ``draws`` (uniforms of each layer's output shape)
    each is followed by dropout of ``rate``."""
    x = torch.relu(P.linear(x, W[p + "fc1.weight"], W[p + "fc1.bias"]))
    if draws is not None:
        x = dropout(x, rate, draws[0])
    x = torch.relu(P.linear(x, W[p + "fc2.weight"], W[p + "fc2.bias"]))
    if draws is not None:
        x = dropout(x, rate, draws[1])
    return x


def encode(P: Prec, W: Weights, c: dict, chars: Tensor, embeds: Tensor,
           draws=None, stats: Optional[Dict[str, Tensor]] = None) -> Tuple[Tensor, Tensor]:
    """chars (B, T) and speaker embeddings (B, S) → (encoder_seq (B, T, E),
    its projection (B, T, D))."""
    x = W["encoder.embedding.weight"][chars.long()]
    x = prenet(P, W, "encoder.pre_net.", x, c["dropout"], draws)
    x = cbhg(P, W, "encoder.cbhg.", x, c["encoder_K"], c["num_highways"], stats=stats)
    e = embeds[:, None, :].expand(-1, x.shape[1], -1)
    seq = torch.cat([x, e], dim=-1)
    return seq, P.linear(seq, W["encoder_proj.weight"])


def decoder_step(P: Prec, W: Weights, c: dict, state, prenet_out: Tensor, enc_seq: Tensor,
                 enc_proj: Tensor, mask: Tensor, zoneout=None):
    """One decoder iteration from ``state`` (attn_h, h1, c1, h2, c2, context,
    cumulative) and the pre-net's output → (state, x (B, L), context, scores).
    With ``zoneout`` (two (B, L) masks) a masked unit keeps its previous
    hidden value."""
    attn_h, h1, c1, h2, c2, ctx, cum = state
    d = "decoder."
    xg = P.linear(torch.cat([ctx, prenet_out], dim=-1), W[d + "attn_rnn.weight_ih"],
                  W[d + "attn_rnn.bias_ih"])
    attn_h = gru_cell(P, xg, attn_h, W[d + "attn_rnn.weight_hh"], W[d + "attn_rnn.bias_hh"])
    q = P.linear(attn_h, W[d + "attn_net.W.weight"], W[d + "attn_net.W.bias"])[:, None, :]
    loc = conv_seq(P, W, d + "attn_net.conv.", cum[:, :, None], 15)
    loc = P.linear(loc, W[d + "attn_net.L.weight"])
    u = P.linear(torch.tanh(q + enc_proj + loc), W[d + "attn_net.v.weight"])[..., 0]
    scores = torch.softmax(u * mask, dim=1)
    cum = cum + scores
    ctx = torch.einsum("bt,btc->bc", scores, enc_seq)
    x = P.linear(torch.cat([ctx, attn_h], dim=1), W[d + "rnn_input.weight"],
                 W[d + "rnn_input.bias"])

    def res(cell, x, h, cc, zo):
        g = (P.linear(x, W[f"{d}{cell}.weight_ih"], W[f"{d}{cell}.bias_ih"])
             + W[f"{d}{cell}.bias_hh"])
        hn, cn = lstm_cell(P, g, h, cc, W[f"{d}{cell}.weight_hh"])
        if zo is not None:
            hn = zo * h + (1.0 - zo) * hn
        return hn, cn

    h1, c1 = res("res_rnn1", x, h1, c1, None if zoneout is None else zoneout[0])
    x = x + h1
    h2, c2 = res("res_rnn2", x, h2, c2, None if zoneout is None else zoneout[1])
    x = x + h2
    return (attn_h, h1, c1, h2, c2, ctx, cum), x, ctx, scores


def init_state(c: dict, B: int, T: int, dev) -> tuple:
    E = c["encoder_dims"] + c["speaker_embedding_size"]
    D, L = c["decoder_dims"], c["lstm_dims"]

    def z(n):
        return torch.zeros((B, n), device=dev)

    return z(D), z(L), z(L), z(L), z(L), z(E), z(T)


def project(P: Prec, W: Weights, c: dict, x: Tensor, ctx: Tensor, r: int):
    """Decoder states → (r frames (B, n_mels, r), stop probability (B,))."""
    M, R = c["n_mels"], c["max_r"]
    mels = P.linear(x, W["decoder.mel_proj.weight"]).reshape(-1, M, R)[:, :, :r]
    stop = torch.sigmoid(P.linear(torch.cat([x, ctx], dim=1), W["decoder.stop_proj.weight"],
                                  W["decoder.stop_proj.bias"]))[:, 0]
    return mels, stop


@torch.no_grad()
def decode_teacher_forced(P: Prec, W: Weights, c: dict, chars: Tensor, embeds: Tensor,
                          frames: Tensor, r: int) -> Tuple[Tensor, Tensor]:
    """The generate decoder without dropout, fed at each iteration the
    previous iteration's last frame from ``frames`` (B, n_mels, n·r), the
    program's own decoder output: its error cannot compound through the
    fed-back frames. → (this decoder's frames (B, n_mels, n·r), stop
    probabilities (B, n))."""
    enc_seq, enc_proj = encode(P, W, c, chars, embeds)
    mask = (chars != 0).float()
    B, M, steps = frames.shape
    state = init_state(c, B, chars.shape[1], frames.device)
    prev = frames.new_zeros((B, M))
    out, stops = [], []
    for i in range(steps // r):
        pre = prenet(P, W, "decoder.prenet.", prev, c["dropout"])
        state, x, ctx, _ = decoder_step(P, W, c, state, pre, enc_seq, enc_proj, mask)
        m, s = project(P, W, c, x, ctx, r)
        out.append(m)
        stops.append(s)
        prev = frames[:, :, (i + 1) * r - 1]
    return torch.cat(out, dim=2), torch.stack(stops, dim=1)


def stop_iterations(stops: Tensor, r: int) -> int:
    """The iterations the generate loop runs: the first where every stop
    probability exceeds 0.5 past frame 10, else all."""
    for i in range(stops.shape[1]):
        if i * r > 10 and bool((stops[:, i] > 0.5).all()):
            return i + 1
    return stops.shape[1]


@torch.no_grad()
def postnet(P: Prec, W: Weights, c: dict, mels: Tensor) -> Tensor:
    """mels (B, n_mels, L) → (B, L, n_mels)."""
    post = cbhg(P, W, "postnet.", mels.transpose(1, 2), c["postnet_K"], c["num_highways"])
    return P.linear(post, W["post_proj.weight"])


def served_mel(c: dict, decoder_frames: Tensor, n: int, P: Prec, W: Weights,
               max_abs: float, bucket: int = 128):
    """The mel a clone returns from the decoder's first ``n`` frames of one
    row: the frames in a ``bucket``-multiple buffer of silence
    (``-max_abs``), the postnet, then trailing frames whose every bin is
    below the stop threshold trimmed. → (n_mels, frames)."""
    buf = torch.full((1, c["n_mels"], -(-n // bucket) * bucket), -max_abs,
                     device=decoder_frames.device)
    buf[:, :, :n] = decoder_frames[None, :, :n]
    m = postnet(P, W, c, buf)[0].t()[:, :n]
    end = m.shape[1]
    while end > 1 and float(m[:, end - 1].max()) < c["stop_threshold"]:
        end -= 1
    return m[:, :end]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_draws(c: dict, B: int, T: int, n_iters: int, generator: torch.Generator, dev):
    """The step's random draws, in the order the training pass takes them
    from one generator: the encoder pre-net's two dropouts (B, T, ·), the
    decoder pre-net's two over every teacher frame (B, n_iters, ·), then the
    two zoneout masks (n_iters, B, L) of p ``ZONEOUT_P``."""
    D, L = c["decoder_dims"], c["lstm_dims"]
    e1 = torch.rand((B, T, c["encoder_dims"]), generator=generator, device=dev)
    e2 = torch.rand((B, T, c["encoder_dims"]), generator=generator, device=dev)
    d1 = torch.rand((B, n_iters, 2 * D), generator=generator, device=dev)
    d2 = torch.rand((B, n_iters, 2 * D), generator=generator, device=dev)
    zo = (torch.rand((2, n_iters, B, L), generator=generator, device=dev) < ZONEOUT_P).float()
    return (e1, e2), (d1, d2), (zo[0], zo[1])


def train_forward(P: Prec, W: Weights, c: dict, batch: Dict[str, Tensor], r: int,
                  generator: torch.Generator):
    """The teacher-forced pass in training mode (batch statistics, dropout,
    zoneout) → (decoder mels, postnet mels (B, n_mels, steps), stop
    probabilities (B, steps), new running statistics)."""
    chars, mels, embeds = batch["chars"], batch["mels"], batch["embeds"]
    B, M, steps = mels.shape
    n_iters = steps // r
    enc_draws, dec_draws, zoneout = train_draws(c, B, chars.shape[1], n_iters, generator,
                                                mels.device)
    stats: Dict[str, Tensor] = {}
    x = W["encoder.embedding.weight"][chars.long()]
    x = prenet(P, W, "encoder.pre_net.", x, c["dropout"], enc_draws)
    x = cbhg(P, W, "encoder.cbhg.", x, c["encoder_K"], c["num_highways"], stats=stats)
    seq = torch.cat([x, embeds[:, None, :].expand(-1, x.shape[1], -1)], dim=-1)
    proj = P.linear(seq, W["encoder_proj.weight"])
    mask = (chars != 0).float()
    teacher = torch.cat([mels.new_zeros((B, 1, M)),
                         mels[:, :, r - 1:steps - 1:r].transpose(1, 2)], dim=1)
    pre_all = prenet(P, W, "decoder.prenet.", teacher, c["dropout"], dec_draws)
    state = init_state(c, B, chars.shape[1], mels.device)
    outs, stops = [], []
    for i in range(n_iters):
        state, xs, ctx, _ = decoder_step(P, W, c, state, pre_all[:, i], seq, proj, mask,
                                         (zoneout[0][i], zoneout[1][i]))
        m, s = project(P, W, c, xs, ctx, r)
        outs.append(m)
        stops.append(s)
    m1 = torch.cat(outs, dim=2)
    stop = torch.stack(stops, dim=1).repeat_interleave(r, dim=1)
    post = cbhg(P, W, "postnet.", m1.transpose(1, 2), c["postnet_K"], c["num_highways"],
                stats=stats)
    m2 = P.linear(post, W["post_proj.weight"]).transpose(1, 2)
    return m1, m2, stop, stats


def loss(m1: Tensor, m2: Tensor, stop: Tensor, mels: Tensor, stop_target: Tensor) -> Tensor:
    """MSE + L1 on the decoder mels, MSE on the postnet's, binary cross
    entropy on the stop tokens (clipped to [1e-7, 1 - 1e-7])."""
    diff = m1 - mels
    p = stop.clamp(1e-7, 1.0 - 1e-7)
    bce = -(stop_target * torch.log(p) + (1.0 - stop_target) * torch.log1p(-p)).mean()
    return (diff ** 2).mean() + diff.abs().mean() + ((m2 - mels) ** 2).mean() + bce

