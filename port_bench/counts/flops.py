"""Operations and bytes of the kernels and of whole requests and steps,
from shapes alone, and the card's published peaks.

A frozen copy of ``chip_smoke.py``'s roofline arithmetic (``bound``,
``nbytes``, ``k1_bound``, ``k2_bound``, ``k5_fwd_bound``), taken from
configuration widths instead of tensors, extended to K5's backward and to
each configuration's model FLOPs for the whole-step MFU. A product of an
(m × k) matrix with a k-vector counts 2·m·k operations; convolutions count
their multiply-adds twice. Each byte a kernel reads or writes is counted
once.
"""
from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA's data sheet for one H100 SXM at 700 W: float32 outside the tensor
# cores, dense bf16 in them, device memory.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(n_bytes: float, flops: float, peak: float = F32_FLOPS) -> Tuple[float, str]:
    """The least seconds the card could take, and which side sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# K1: the WaveRNN sample loop (runtimeracer layout)
# ---------------------------------------------------------------------------


def k1_weights(v: dict) -> Tuple[int, int]:
    """(elements of the loop's matrices, elements of all its weights) for the
    runtimeracer variant: four GRUs of rnn_dims (rnn3's aux columns hoisted
    out), five FCs (fc1 and fc3's aux columns hoisted out), the input
    column."""
    R, F, C = v["rnn_dims"], v["fc_dims"], 2 ** v["bits"]
    mats = 4 * 2 * 3 * R * R + F * R + F * F + F * F + F * F + C * F
    vecs = R + 3 * (3 * R) + 4 * (3 * R) + F + F + C  # i_col; b_ih of rnn1,2,4; b_hh; fc2,4,5
    return mats, mats + vecs


def k1_stream_width(v: dict) -> int:
    R, F = v["rnn_dims"], v["fc_dims"]
    return R + 3 * R + F + F  # i_cond, rnn3_aux, fc1_aux, fc3_aux


def k1(v: dict, folds: int, steps: int) -> Tuple[float, float]:
    """(operations, bytes) of one launch over ``folds`` × ``steps``: every
    matrix applied once to every fold and step; the weights, the streams
    and the samples moved once."""
    mats, allw = k1_weights(v)
    flops = 2.0 * folds * steps * mats
    n_bytes = F32 * (allw + folds * steps * (k1_stream_width(v) + 1))
    return flops, n_bytes


def k1_bound_s(v: dict, launches: Iterable[Tuple[int, int]]) -> float:
    return sum(bound_s(*reversed(k1(v, b, t)))[0] for b, t in launches)


# ---------------------------------------------------------------------------
# K2 and K5: the Tacotron decoder chain
# ---------------------------------------------------------------------------


def _decoder_mats(t: dict, r: int) -> int:
    """Elements of the matrices one decoder iteration applies to a row
    (K2's list: pre-net, attention GRU, query, rnn_input, two LSTMs, stop; the
    mel projection's r frames)."""
    D, L, M = t["decoder_dims"], t["lstm_dims"], t["n_mels"]
    E = t["encoder_dims"] + t["speaker_embedding_size"]
    return (M * 2 * D + 2 * D * 2 * D + 3 * D * (E + 2 * D) + 3 * D * D + D * D
            + L * (E + D) + 2 * (4 * L * L + 4 * L * L) + (L + E) + r * M * L)


def _attention(t: dict, T: int) -> int:
    """Multiply-adds of one row's attention over T characters: the 31-tap
    location conv into 32 filters, their projection, the energies and the
    context."""
    D = t["decoder_dims"]
    E = t["encoder_dims"] + t["speaker_embedding_size"]
    return T * (32 * 31 + D * 32 + D + E)


def k2(t: dict, r: int, iters: int, B: int, T: int) -> float:
    """K2's operations for ``iters`` iterations at B rows × T characters."""
    return 2.0 * iters * B * (_decoder_mats(t, r) + _attention(t, T))


def k5_fwd(t: dict, B: int, iters: int, T: int) -> Tuple[float, float]:
    """K5's forward (the teacher-forced chain): per row and iteration the
    attention GRU's recurrent and context products, the query, rnn_input,
    both LSTMs, then the attention. Bytes: weights, the hoisted pre-net
    product, the encoder sequence and its projection, the zoneout masks,
    and the per-iteration outputs (x, context, scores) once."""
    D, L = t["decoder_dims"], t["lstm_dims"]
    E = t["encoder_dims"] + t["speaker_embedding_size"]
    mats = D * 3 * D + D * D + (E + D) * L + 4 * L * 4 * L + E * 3 * D
    flops = 2.0 * iters * B * (mats + T * D * 31 + 2 * T * D + T * E)
    n_bytes = F32 * (mats + iters * B * 3 * D + B * T * (E + D + 1)
                     + 2 * iters * B * L + iters * B * (L + E + T))
    return flops, n_bytes


def k5_bwd(t: dict, B: int, iters: int, T: int) -> Tuple[float, float]:
    """K5's backward walk: the transposed products of the forward's chain
    (each as many multiply-adds as its forward product) and the attention's
    backward (as many again); bytes as the forward's, plus the stored
    residuals read once (gates of the GRU and both LSTMs, their states, the
    scores)."""
    flops, n_bytes = k5_fwd(t, B, iters, T)
    D, L = t["decoder_dims"], t["lstm_dims"]
    res = iters * B * (4 * D + 2 * (4 * L + 2 * L) + T)
    return flops, n_bytes + F32 * res


# ---------------------------------------------------------------------------
# Model FLOPs of whole requests and steps
# ---------------------------------------------------------------------------


def cbhg(T: int, K: int, cin: int, ch: int, proj: Tuple[int, int], highways: int,
         gru_h: int, pre_highway: bool) -> float:
    macs = sum(k for k in range(1, K + 1)) * cin * ch
    macs += 3 * K * ch * proj[0] + 3 * proj[0] * proj[1]
    if pre_highway:
        macs += proj[1] * ch
    macs += highways * 2 * ch * ch
    macs += 2 * (3 * gru_h * ch + 3 * gru_h * gru_h)
    return 2.0 * T * macs


def encoder(e: dict, partials: int, frames: int = 160) -> float:
    H, I = e["hidden"], e["mel_channels"]
    macs = sum(4 * H * (I if k == 0 else H) + 4 * H * H for k in range(e["layers"]))
    return 2.0 * partials * (frames * macs + H * e["embedding"])


def tacotron_encode(t: dict, B: int, T: int) -> float:
    C = t["encoder_dims"]
    E = C + t["speaker_embedding_size"]
    pre = 2.0 * B * T * (t["embed_dims"] * C + C * C)
    return (pre + B * cbhg(T, t["encoder_K"], C, C, (C, C), t["num_highways"], C // 2,
                           False) + 2.0 * B * T * E * t["decoder_dims"])


def tacotron_postnet(t: dict, B: int, frames: int) -> float:
    M, P = t["n_mels"], t["postnet_dims"]
    return B * cbhg(frames, t["postnet_K"], M, P, (P, M), t["num_highways"], P // 2,
                    True) + 2.0 * B * frames * P * M


def tacotron_generate(t: dict, B: int, T: int, iters: int, r: int, post_frames: int) -> float:
    return (tacotron_encode(t, B, T) + k2(t, r, iters, B, T)
            + tacotron_postnet(t, B, post_frames))


def tacotron_train_step(t: dict, B: int, T: int, frames: int, r: int) -> float:
    """The teacher-forced forward at B rows, T characters and ``frames``
    frames (all iterations, the pre-net over every teacher frame, the mel
    projection's r rows), × 3 for the backward's two products per forward
    product."""
    iters = frames // r
    fwd = (tacotron_encode(t, B, T) + k2(t, r, iters, B, T)
           + tacotron_postnet(t, B, frames))
    return 3.0 * fwd


def wavernn_generate(v: dict, n_frames_padded: int, folds: int, steps: int) -> float:
    """The upsampler over the padded mel (MelResNet per frame, the
    smoothing convs per upsampled sample), the hoisted conditioning streams
    per fold and step, and K1."""
    M, Cd, Ro, R, F = v["n_mels"], v["compute_dims"], v["res_out_dims"], v["rnn_dims"], v["fc_dims"]
    A = Ro // 4
    frames = n_frames_padded + 2 * v["pad"]
    res = frames * (M * Cd * (2 * v["pad"] + 1) + v["res_blocks"] * 2 * Cd * Cd + Cd * Ro)
    hop = 1
    for s in v["upsample_factors"]:
        hop *= s
    smooth = n_frames_padded * hop * M * sum(2 * s + 1 for s in v["upsample_factors"])
    streams = folds * steps * ((M + A - 1) * R + A * 3 * R + 2 * A * F)
    return 2.0 * (res + smooth + streams) + k1(v, folds, steps)[0]


def forward_tacotron_generate(f: dict, B: int, T: int, L: int) -> float:
    spk, M = f["speaker_embedding_size"], f["n_mels"]
    flops = 0.0
    for name in ("duration", "pitch", "energy"):
        conv, rnn = f[f"{name}_conv_dims"], f[f"{name}_rnn_dims"]
        macs = 5 * (f["series_embed_dims"] + spk) * conv + 2 * 5 * conv * conv
        macs += 2 * (3 * rnn * conv + 3 * rnn * rnn) + 2 * rnn
        flops += 2.0 * B * T * macs
    P = f["prenet_dims"]
    flops += B * cbhg(T, f["prenet_k"], f["embed_dims"], P, (P, f["embed_dims"]),
                      f["prenet_num_highways"], P, True)
    flops += 2.0 * B * T * 2 * (3 * 2 * P)
    H, I = f["rnn_dims"], 2 * P + spk
    flops += 2.0 * B * L * 2 * (4 * H * I + 4 * H * H) + 2.0 * B * L * 2 * H * M
    Q = f["postnet_dims"]
    flops += B * cbhg(L, f["postnet_k"], M, Q, (Q, M), f["postnet_num_highways"], Q, True)
    return flops + 2.0 * B * L * 2 * Q * M

