"""ForwardTacotron (non-autoregressive synthesizer), counterpart of
``rtvc_tpu/models/forward_tacotron.py``.

Three series predictors (duration, pitch, energy: embedding ‖ speaker, three
BatchNorm convs, a BiGRU, a linear head) over the characters; the trunk is
embedding → CBHG prenet (ForwardTacotron's variant) → + the pitch and
energy projections → length regulator → ‖ speaker → packed BiLSTM → mel
head → CBHG postnet → projection. Parameters carry the reference's torch
state-dict names.

Kernels: each of the five BiGRUs is ``layers.GRU`` (K4, one launch a
direction), and each direction of the BiLSTM is one input product and one
K3 sequence from a zero state: ``ops.lstm_seq.lstm_seq`` without a
gradient, ``LSTMSeqFn`` (K3's forward with residuals, then its backward)
with one. On CPU tensors both run their plain versions.

:func:`forward_tacotron_forward` is the teacher-forced forward: ground-truth
durations, pitch and energy, the predictors and the prenet CBHG in train
mode (dropout from the step's generator, BatchNorm batch statistics) or,
with ``train=False`` (the GTA pass), in eval mode; the postnet CBHG over
the whole padded buffer either way, as the JAX package runs it.

:func:`forward_generate` is the generate path, on the host as the JAX
package does it: predict, divide the durations by ``alpha``, apply the
pitch and energy functions, round, then synthesize. The JAX package
synthesizes at a 128-frame bucket to bound XLA's compiled shapes; this one
at the batch's longest ``mel_lens`` (only valid frames are returned, and
the postnet is length-exact, so the valid frames are the same).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rtvc_tpu_torch.config.synthesizer import ForwardTacotronParams
from rtvc_tpu_torch.models.layers import (
    CBHG,
    GRU,
    BatchNormConv,
    Conv1d,
    Embedding,
    Linear,
    always_dropout,
    length_regulate,
)
from rtvc_tpu_torch.ops.lstm_seq import LSTMSeqFn, lstm_seq

Tensor = torch.Tensor


class ForwardTacotronDims(NamedTuple):
    """Static dimensions (same fields as the JAX package's)."""

    num_chars: int
    n_mels: int
    speaker_embedding_size: int
    embed_dims: int
    series_embed_dims: int
    duration_conv_dims: int
    duration_rnn_dims: int
    duration_dropout: float
    pitch_conv_dims: int
    pitch_rnn_dims: int
    pitch_dropout: float
    pitch_strength: float
    energy_conv_dims: int
    energy_rnn_dims: int
    energy_dropout: float
    energy_strength: float
    prenet_dims: int
    prenet_k: int
    prenet_num_highways: int
    prenet_dropout: float
    rnn_dims: int
    postnet_dims: int
    postnet_k: int
    postnet_num_highways: int
    postnet_dropout: float
    padding_value: float

    @classmethod
    def from_config(cls, cfg: ForwardTacotronParams, num_chars: int, n_mels: int,
                    spk: int) -> "ForwardTacotronDims":
        fields = {f: getattr(cfg, f) for f in cls._fields if hasattr(cfg, f)}
        return cls(num_chars=num_chars, n_mels=n_mels, speaker_embedding_size=spk,
                   padding_value=-11.5129,  # log(1e-5), the reference's mel floor
                   **fields)


class SeriesPredictor(nn.Module):
    """Embedding ‖ speaker → 3 × BatchNormConv(5) → BiGRU → Linear(1)."""

    def __init__(self, num_chars: int, emb_dims: int, spk: int, conv_dims: int,
                 rnn_dims: int, device=None):
        super().__init__()
        self.embedding = Embedding(num_chars, emb_dims, device=device)
        self.convs = nn.ModuleList(
            BatchNormConv(emb_dims + spk if i == 0 else conv_dims, conv_dims, 5, device=device)
            for i in range(3))
        self.rnn = GRU(conv_dims, rnn_dims, bidirectional=True, device=device)
        self.lin = Linear(2 * rnn_dims, 1, device=device)

    def forward(self, x: Tensor, spk_emb: Tensor, new_stats: Optional[Dict[str, Tensor]] = None,
                prefix: str = "", dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """chars (B, T), speaker embeddings (B, E) → (B, T, 1). With
        ``new_stats`` (training) the BatchNorms use the batch's statistics
        and leave their new running statistics there under ``prefix``, and
        each conv's output takes dropout of rate ``dropout`` from
        ``generator``."""
        h = self.embedding(x)
        h = torch.cat([h, spk_emb[:, None, :].expand(-1, h.shape[1], -1)], dim=2)
        for i, conv in enumerate(self.convs):
            h = conv(h, new_stats, f"{prefix}convs.{i}.")
            if new_stats is not None:
                h = always_dropout(h, dropout, generator)
        h, _ = self.rnn(h)
        return self.lin(h)


class BiLSTM(nn.Module):
    """A bidirectional single-layer LSTM's parameters under
    ``torch.nn.LSTM(bidirectional=True)``'s names; run by
    :func:`bilstm_packed`."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        H = hidden_size
        for sfx in ("", "_reverse"):
            for name, shape in (("weight_ih", (4 * H, input_size)), ("weight_hh", (4 * H, H)),
                                ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                self.register_parameter(f"{name}_l0{sfx}",
                                        nn.Parameter(torch.empty(shape, device=device)))


class ForwardTacotron(nn.Module):
    """Parameter container under the reference's state-dict names."""

    def __init__(self, d: ForwardTacotronDims, device=None):
        super().__init__()
        self.dims = d
        spk = d.speaker_embedding_size
        for name, conv, rnn in (("dur_pred", d.duration_conv_dims, d.duration_rnn_dims),
                                ("pitch_pred", d.pitch_conv_dims, d.pitch_rnn_dims),
                                ("energy_pred", d.energy_conv_dims, d.energy_rnn_dims)):
            setattr(self, name, SeriesPredictor(d.num_chars, d.series_embed_dims, spk, conv,
                                                rnn, device=device))
        self.embedding = Embedding(d.num_chars, d.embed_dims, device=device)
        self.prenet = CBHG(d.prenet_k, d.embed_dims, d.prenet_dims,
                           (d.prenet_dims, d.embed_dims), d.prenet_num_highways,
                           forward_variant=True, dropout=d.prenet_dropout, device=device)
        self.lstm = BiLSTM(2 * d.prenet_dims + spk, d.rnn_dims, device=device)
        self.lin = Linear(2 * d.rnn_dims, d.n_mels, device=device)
        self.postnet = CBHG(d.postnet_k, d.n_mels, d.postnet_dims,
                            (d.postnet_dims, d.n_mels), d.postnet_num_highways,
                            forward_variant=True, dropout=d.postnet_dropout, device=device)
        self.post_proj = Linear(2 * d.postnet_dims, d.n_mels, bias=False, device=device)
        self.pitch_proj = Conv1d(1, 2 * d.prenet_dims, 3, padding=1, device=device)
        self.energy_proj = Conv1d(1, 2 * d.prenet_dims, 3, padding=1, device=device)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _lstm_dir(lstm: BiLSTM, sfx: str, x: Tensor) -> Tensor:
    """One direction from a zero state: the input product for the whole
    sequence, then K3 (its plain version for a CPU tensor): the inference
    kernel without a gradient, ``LSTMSeqFn`` with one."""
    w_ih = getattr(lstm, f"weight_ih_l0{sfx}")
    b = getattr(lstm, f"bias_ih_l0{sfx}") + getattr(lstm, f"bias_hh_l0{sfx}")
    xg = (x @ w_ih.t() + b).contiguous()
    h0 = torch.zeros((x.shape[0], lstm.hidden_size), device=x.device,
                     dtype=torch.promote_types(x.dtype, torch.float32))  # f32 state under bf16
    seq = LSTMSeqFn.apply if torch.is_grad_enabled() else lstm_seq
    return seq(xg, getattr(lstm, f"weight_hh_l0{sfx}").contiguous(), h0, h0)[0]


def bilstm_packed(lstm: BiLSTM, x: Tensor, lens: Tensor, padding_value: float) -> Tensor:
    """The BiLSTM with ``pack_padded_sequence`` semantics on (B, T, I): the
    reverse direction reads each row reversed by its own length (a gather
    before and after), and positions at or past a row's length take
    ``padding_value``. Pad frames follow a row's valid ones in both
    directions, so their cotangents are zero and ``dxg`` is zero there."""
    B, T, _ = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    lens = lens.to(device=x.device, dtype=torch.long)[:, None]
    mask = (t < lens)[..., None]
    fwd = _lstm_dir(lstm, "", x)
    rev = (lens - 1 - t).clamp(0, T - 1)[..., None]
    x_rev = torch.where(mask, x.gather(1, rev.expand(-1, -1, x.shape[2])), 0.0)
    bwd = _lstm_dir(lstm, "_reverse", x_rev)
    bwd = bwd.gather(1, rev.expand(-1, -1, bwd.shape[2]))
    return torch.where(mask, torch.cat([fwd, bwd], dim=-1), padding_value)


_PREDICTORS = ("dur_pred", "pitch_pred", "energy_pred")


def predict(model: ForwardTacotron, x: Tensor, spk_emb: Tensor,
            new_stats: Optional[Dict[str, Tensor]] = None,
            generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The three predictors → (durations, pitch, energy), each (B, T, 1);
    ``new_stats`` and ``generator`` as in :meth:`SeriesPredictor.forward`,
    each at its own dropout rate."""
    d = model.dims
    rates = (d.duration_dropout, d.pitch_dropout, d.energy_dropout)
    return tuple(getattr(model, name)(x, spk_emb, new_stats, f"{name}.", rate, generator)
                 for name, rate in zip(_PREDICTORS, rates))


def mel_synthesis(model: ForwardTacotron, x: Tensor, spk_emb: Tensor, durations: Tensor,
                  pitch: Tensor, energy: Tensor, mel_lens: Tensor, max_len: int,
                  new_stats: Optional[Dict[str, Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  exact_lengths: bool = True) -> Tuple[Tensor, Tensor]:
    """The trunk: pitch and energy (B, T, 1), integer durations (B, T) and
    their sums ``mel_lens`` (B,) → (mel, mel_post), each (B, n_mels,
    max_len). In generation the postnet is length-exact (the CBHG with
    ``lengths``), as the reference runs it on each unpadded sequence; frames
    past a row's length hold lin(padding_value). With ``new_stats``
    (training) both CBHGs use batch statistics and their dropout draws from
    ``generator``. ``exact_lengths=False`` runs the postnet over the whole
    buffer, as the teacher-forced forward does in training and in eval
    mode."""
    d = model.dims
    h = model.prenet(model.embedding(x), new_stats=new_stats, prefix="prenet.",
                     generator=generator)
    h = h + model.pitch_proj(pitch) * d.pitch_strength
    h = h + model.energy_proj(energy) * d.energy_strength
    h = length_regulate(h, durations, max_len)
    h = torch.cat([h, spk_emb[:, None, :].expand(-1, max_len, -1)], dim=2)
    h = bilstm_packed(model.lstm, h, mel_lens, d.padding_value)
    mel = model.lin(h)
    post = model.postnet(mel, lengths=mel_lens if exact_lengths else None,
                         new_stats=new_stats, prefix="postnet.", generator=generator)
    return mel.transpose(1, 2), model.post_proj(post).transpose(1, 2)


def forward_tacotron_forward(model: ForwardTacotron, x: Tensor, mel: Tensor, dur: Tensor,
                             spk_emb: Tensor, mel_lens: Tensor, pitch: Tensor, energy: Tensor,
                             generator: Optional[torch.Generator] = None, train: bool = True
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                        Dict[str, Tensor]]:
    """The teacher-forced forward (``rtvc_tpu/models/forward_tacotron.py:
    forward_tacotron_forward``). chars (B, T), target
    mels (B, n_mels, L) (only L is read), ground-truth durations, pitch and
    energy (B, T), speaker embeddings (B, E), ``mel_lens`` (B,). The
    durations are rounded as ``max(floor(d + 0.5), 0)`` and length-regulated
    to L; dropout draws from ``generator``. Returns (mel_hat, mel_post
    (B, n_mels, L), dur_hat (B, T), pitch_hat, energy_hat (B, 1, T),
    new_stats): the BatchNorms' new running statistics under their buffers'
    names, which the step installs. ``train=False`` (the GTA pass) is the
    JAX package's eval mode: running statistics, no dropout (``generator``
    is not read), no new statistics, and the postnet over the whole padded
    buffer, as in training."""
    new_stats: Dict[str, Tensor] = {}
    batch_stats = new_stats if train else None
    dur_hat, pitch_hat, energy_hat = predict(model, x, spk_emb, batch_stats, generator)
    durations = torch.floor(dur + 0.5).clamp_min(0).long()
    mel_hat, mel_post = mel_synthesis(model, x, spk_emb, durations, pitch[..., None],
                                      energy[..., None], mel_lens, mel.shape[2], batch_stats,
                                      generator, exact_lengths=False)
    return (mel_hat, mel_post, dur_hat[..., 0], pitch_hat.transpose(1, 2),
            energy_hat.transpose(1, 2), new_stats)


def round_durations(dur_hat: np.ndarray) -> np.ndarray:
    """Predicted durations (B, T) → integer frames, as the reference does:
    if the truncated predictions sum to ≤ 0 over the batch every duration
    becomes 2.0; then floor(d + 0.5), negatives to 0."""
    if np.trunc(dur_hat).sum() <= 0:
        dur_hat = np.full_like(dur_hat, 2.0)
    return np.maximum(np.floor(dur_hat + 0.5), 0.0).astype(np.int32)


def apply_series_function(fn: Optional[Callable], series: Tensor) -> Tensor:
    """A user's pitch or energy function on a (B, T, 1) prediction: it
    receives (B, 1, T) as a numpy array, as the JAX package passes it, and
    its result comes back as (B, T, 1) on the prediction's device."""
    if fn is None:
        return series
    out = np.asarray(fn(series.transpose(1, 2).cpu().numpy()), np.float32)
    return torch.as_tensor(out, device=series.device).transpose(1, 2)


@torch.no_grad()
def forward_generate(model: ForwardTacotron, x: Tensor, spk_emb: Tensor, alpha: float = 1.0,
                     pitch_function: Optional[Callable] = None,
                     energy_function: Optional[Callable] = None
                     ) -> Tuple[Tensor, np.ndarray]:
    """chars (B, T) and speaker embeddings (B, E) on the model's device →
    (mel_post (B, n_mels, max mel_len) on the device, durations (B, T) int32
    on the host). ``alpha`` divides the predicted durations (1 /
    speed_modifier); ``pitch_function`` / ``energy_function`` act on the
    (B, 1, T) predictions."""
    dur, pitch, energy = predict(model, x, spk_emb)
    durations = round_durations(dur[..., 0].cpu().numpy() / alpha)
    pitch = apply_series_function(pitch_function, pitch)
    energy = apply_series_function(energy_function, energy)
    mel_lens = durations.sum(axis=1)
    max_len = max(int(mel_lens.max()), 1)
    dev = x.device
    _, mel_post = mel_synthesis(model, x, spk_emb, torch.as_tensor(durations, device=dev),
                                pitch, energy, torch.as_tensor(mel_lens, device=dev), max_len)
    return mel_post, durations
