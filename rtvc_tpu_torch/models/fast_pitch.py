"""FastPitch (transformer non-autoregressive synthesizer), counterpart of
``rtvc_tpu/models/fast_pitch.py``.

FFT blocks (multi-head self-attention with ``torch.nn.MultiheadAttention``'s
packed ``in_proj`` and key padding mask, two k//2-padded convs, LayerNorms),
a sinusoidal positional encoding with a learned scale, transformer series
predictors for duration, pitch and energy, the length regulator, a postnet
transformer and the mel head. As in the JAX package, a linear speaker
projection is added to the embedded characters of the trunk and of every
predictor (the reference FastPitch has no speaker conditioning).

No recurrence and no kernel of its own: the attention is written out as
products and a softmax in f32, as the JAX package writes it; the softmax and
the layer norms stay f32 under the bf16 training policy.
:func:`fastpitch_forward` is the training forward (ground-truth durations,
pitch and energy; dropout in the FFT blocks and the predictors, drawn from
the step's generator).
:func:`fastpitch_generate` is the generate path (see
``models.forward_tacotron.forward_generate``: the same host-side rounding,
guard and functions, synthesized at the batch's longest ``mel_lens``).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtvc_tpu_torch.config.synthesizer import FastPitchParams
from rtvc_tpu_torch.models.forward_tacotron import apply_series_function, round_durations
from rtvc_tpu_torch.models.layers import (
    Conv1d,
    Embedding,
    Linear,
    always_dropout,
    length_regulate,
)
from rtvc_tpu_torch.ops.precision import widen

Tensor = torch.Tensor


class FastPitchDims(NamedTuple):
    """Static dimensions (same fields as the JAX package's)."""

    num_chars: int
    n_mels: int
    speaker_embedding_size: int
    d_model: int
    n_heads: int
    d_fft: int
    conv_kernel: int
    dropout: float
    n_layers_enc: int
    n_layers_dec: int
    series_d_model: int
    series_n_heads: int
    series_layers: int
    series_d_fft: int
    series_dropout: float
    pitch_strength: float
    energy_strength: float
    padding_value: float

    @classmethod
    def from_config(cls, cfg: FastPitchParams, num_chars: int, n_mels: int,
                    spk: int) -> "FastPitchDims":
        return cls(
            num_chars=num_chars, n_mels=n_mels, speaker_embedding_size=spk,
            d_model=cfg.embed_dims, n_heads=cfg.n_heads, d_fft=cfg.conv_dims,
            conv_kernel=cfg.conv_kernel, dropout=cfg.dropout,
            n_layers_enc=cfg.n_layers_enc, n_layers_dec=cfg.n_layers_dec,
            series_d_model=cfg.series_d_model, series_n_heads=cfg.series_n_heads,
            series_layers=cfg.series_layers, series_d_fft=cfg.series_d_fft,
            series_dropout=cfg.series_dropout, pitch_strength=cfg.pitch_strength,
            energy_strength=cfg.energy_strength, padding_value=-11.5129,
        )


# ---------------------------------------------------------------------------
# Transformer pieces (torch parameter names)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _pe_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@functools.lru_cache(maxsize=8)
def _pe_on(d_model: int, device: torch.device) -> Tensor:
    return torch.as_tensor(_pe_table(d_model), device=device)


def positional_encoding_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """The sinusoidal table (max_len, d_model), as the reference builds it."""
    return _pe_table(d_model, max_len).copy()


def layer_norm(norm: nn.LayerNorm, x: Tensor) -> Tensor:
    """``norm(x)`` with its moments and affine map in f32 under any policy,
    the result in ``x``'s dtype (``rtvc_tpu/models/fast_pitch.py:layer_norm``)."""
    return F.layer_norm(widen(x), norm.normalized_shape, widen(norm.weight), widen(norm.bias),
                        norm.eps).to(x.dtype)


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters: packed ``in_proj`` and
    ``out_proj``; see :meth:`forward`."""

    def __init__(self, embed_dim: int, n_heads: int, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = Linear(embed_dim, embed_dim, device=device)

    def forward(self, x: Tensor, key_padding_mask: Optional[Tensor]) -> Tensor:
        """Self-attention over x (B, T, E); ``key_padding_mask`` (B, T) is
        True at pads, whose scores become −inf; the softmax is in f32."""
        B, T, E = x.shape
        H = self.n_heads
        q, k, v = (x @ self.in_proj_weight.t() + self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, T, H, E // H).transpose(1, 2) for t in (q, k, v))
        scores = q @ k.transpose(-1, -2) / math.sqrt(E // H)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, T, E)
        return self.out_proj(out)


class FFTBlock(nn.Module):
    """Self-attention + conv feed-forward (two k//2-padded convs)."""

    def __init__(self, d_model: int, n_heads: int, d_fft: int, kernel: int, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, device=device)
        self.conv1 = Conv1d(d_model, d_fft, kernel, padding=kernel // 2, device=device)
        self.conv2 = Conv1d(d_fft, d_model, kernel, padding=kernel // 2, device=device)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)

    def forward(self, x: Tensor, key_padding_mask: Optional[Tensor],
                exact_lengths: bool = False, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """``exact_lengths`` zeroes pad frames after each LayerNorm and
        between the convs, so that the convs see the zeros an unpadded run
        has past its end. ``dropout`` (training) drops the attention's and
        the second conv's outputs ahead of their residual sums, drawn from
        ``generator``."""
        def drop(v):
            return always_dropout(v, dropout, generator) if dropout else v

        if exact_lengths and key_padding_mask is not None:
            valid = (~key_padding_mask)[..., None].to(x.dtype)

            def remask(v):
                return v * valid
        else:
            def remask(v):
                return v
        T = x.shape[1]
        x = remask(layer_norm(self.norm1, x + drop(self.self_attn(x, key_padding_mask))))
        h = remask(torch.relu(self.conv1(x)[:, :T]))
        h = self.conv2(h)[:, :T]
        return remask(layer_norm(self.norm2, x + drop(h)))


class PositionalEncoding(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(1, device=device))


class ForwardTransformer(nn.Module):
    """Positional encoding → FFT blocks → LayerNorm."""

    def __init__(self, d_model: int, n_heads: int, d_fft: int, n_layers: int, kernel: int,
                 device=None):
        super().__init__()
        self.pos_encoder = PositionalEncoding(device=device)
        self.layers = nn.ModuleList(FFTBlock(d_model, n_heads, d_fft, kernel, device=device)
                                    for _ in range(n_layers))
        self.norm = nn.LayerNorm(d_model, device=device)

    def forward(self, x: Tensor, key_padding_mask: Optional[Tensor],
                exact_lengths: bool = False, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """``dropout`` (training) drops the positionally encoded input and,
        in each FFT block, as :meth:`FFTBlock.forward` does."""
        pe = _pe_on(x.shape[-1], x.device)[:x.shape[1]]
        x = x + (self.pos_encoder.scale * pe[None]).to(x.dtype)
        if dropout:
            x = always_dropout(x, dropout, generator)
        for layer in self.layers:
            x = layer(x, key_padding_mask, exact_lengths, dropout, generator)
        return layer_norm(self.norm, x)


class SeriesPredictor(nn.Module):
    """Embedding + speaker projection → transformer → Linear(1)."""

    def __init__(self, d: "FastPitchDims", device=None):
        super().__init__()
        dm = d.series_d_model
        self.embedding = Embedding(d.num_chars, dm, device=device)
        self.spk_proj = Linear(d.speaker_embedding_size, dm, device=device)
        self.transformer = ForwardTransformer(dm, d.series_n_heads, d.series_d_fft,
                                              d.series_layers, d.conv_kernel, device=device)
        self.lin = Linear(dm, 1, device=device)

    def forward(self, x: Tensor, spk_emb: Tensor, pad_mask: Optional[Tensor],
                dropout: float = 0.0, generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.embedding(x) + self.spk_proj(spk_emb)[:, None, :]
        return self.lin(self.transformer(h, pad_mask, dropout=dropout, generator=generator))


class FastPitch(nn.Module):
    """Parameter container under the reference's state-dict names (plus
    the speaker projections ``spk_proj``)."""

    def __init__(self, d: FastPitchDims, device=None):
        super().__init__()
        self.dims = d
        for name in ("dur_pred", "pitch_pred", "energy_pred"):
            setattr(self, name, SeriesPredictor(d, device=device))
        self.embedding = Embedding(d.num_chars, d.d_model, device=device)
        self.spk_proj = Linear(d.speaker_embedding_size, d.d_model, device=device)
        self.prenet = ForwardTransformer(d.d_model, d.n_heads, d.d_fft, d.n_layers_enc,
                                         d.conv_kernel, device=device)
        self.postnet = ForwardTransformer(d.d_model, d.n_heads, d.d_fft, d.n_layers_dec,
                                          d.conv_kernel, device=device)
        self.lin = Linear(d.d_model, d.n_mels, device=device)
        self.pitch_proj = Conv1d(1, d.d_model, 3, padding=1, device=device)
        self.energy_proj = Conv1d(1, d.d_model, 3, padding=1, device=device)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


def predict(model: FastPitch, x: Tensor, spk_emb: Tensor, dropout: float = 0.0,
            generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The three predictors (characters 0 are pads, masked as keys) →
    (durations, pitch, energy), each (B, T, 1)."""
    pad_mask = x == 0
    return tuple(getattr(model, name)(x, spk_emb, pad_mask, dropout, generator)
                 for name in ("dur_pred", "pitch_pred", "energy_pred"))


def mel_synthesis(model: FastPitch, x: Tensor, spk_emb: Tensor, durations: Tensor,
                  pitch: Tensor, energy: Tensor, mel_lens: Tensor, max_len: int) -> Tensor:
    """The inference trunk → mel (B, n_mels, max_len): pad frames are
    zeroed before the postnet, which runs length-exact (pads masked as keys
    and zeroed between its stages), and take ``padding_value`` after it."""
    d = model.dims
    h = model.embedding(x) + model.spk_proj(spk_emb)[:, None, :]
    h = model.prenet(h, x == 0)
    h = h + model.pitch_proj(pitch) * d.pitch_strength
    h = h + model.energy_proj(energy) * d.energy_strength
    h = length_regulate(h, durations, max_len)
    mel_pad = (torch.arange(max_len, device=h.device)[None, :]
               >= mel_lens.to(h.device)[:, None])
    h = h.masked_fill(mel_pad[..., None], 0.0)
    h = model.postnet(h, mel_pad, exact_lengths=True)
    m = model.lin(h).masked_fill(mel_pad[..., None], d.padding_value)
    return m.transpose(1, 2)


def fastpitch_forward(model: FastPitch, x: Tensor, mel: Tensor, dur: Tensor, spk_emb: Tensor,
                      mel_lens: Tensor, pitch: Tensor, energy: Tensor,
                      generator: Optional[torch.Generator] = None, train: bool = True
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Dict[str, Tensor]]:
    """The teacher-forced forward (``rtvc_tpu/models/fast_pitch.py:
    fastpitch_forward``), with the arguments and outputs of
    ``forward_tacotron.forward_tacotron_forward`` (mel_hat and mel_post are
    the same tensor, and FastPitch has no running statistics). In training
    the FFT blocks and the predictors take dropout from ``generator``;
    ``train=False`` (the GTA pass) draws none. The frames past a row's
    ``mel_lens`` are zeroed before the decoder transformer, which masks them
    as keys, and take ``padding_value`` after ``lin``."""
    d = model.dims
    pad_mask = x == 0
    series_dropout, dropout = (d.series_dropout, d.dropout) if train else (0.0, 0.0)
    dur_hat, pitch_hat, energy_hat = predict(model, x, spk_emb, series_dropout, generator)
    h = model.embedding(x) + model.spk_proj(spk_emb)[:, None, :]
    h = model.prenet(h, pad_mask, dropout=dropout, generator=generator)
    h = h + model.pitch_proj(pitch[..., None]) * d.pitch_strength
    h = h + model.energy_proj(energy[..., None]) * d.energy_strength
    max_len = mel.shape[2]
    h = length_regulate(h, torch.floor(dur + 0.5).clamp_min(0).long(), max_len)
    mel_pad = (torch.arange(max_len, device=h.device)[None, :]
               >= mel_lens.to(h.device)[:, None])
    h = h.masked_fill(mel_pad[..., None], 0.0)
    h = model.postnet(h, mel_pad, dropout=dropout, generator=generator)
    m = model.lin(h).masked_fill(mel_pad[..., None], d.padding_value).transpose(1, 2)
    return (m, m, dur_hat[..., 0], pitch_hat.transpose(1, 2), energy_hat.transpose(1, 2), {})


@torch.no_grad()
def fastpitch_generate(model: FastPitch, x: Tensor, spk_emb: Tensor, alpha: float = 1.0,
                       pitch_function: Optional[Callable] = None,
                       energy_function: Optional[Callable] = None
                       ) -> Tuple[Tensor, np.ndarray]:
    """chars (B, T) and speaker embeddings (B, E) on the model's device →
    (mel (B, n_mels, max mel_len) on the device, durations (B, T) int32 on
    the host); ``alpha``, ``pitch_function`` and ``energy_function`` as in
    ``forward_tacotron.forward_generate``."""
    dur, pitch, energy = predict(model, x, spk_emb)
    durations = round_durations(dur[..., 0].cpu().numpy() / alpha)
    pitch = apply_series_function(pitch_function, pitch)
    energy = apply_series_function(energy_function, energy)
    mel_lens = durations.sum(axis=1)
    dev = x.device
    mel = mel_synthesis(model, x, spk_emb, torch.as_tensor(durations, device=dev), pitch,
                        energy, torch.as_tensor(mel_lens, device=dev),
                        max(int(mel_lens.max()), 1))
    return mel, durations

