"""Tacotron (autoregressive seq2seq synthesizer), counterpart of
``rtvc_tpu/models/tacotron.py``.

Encoder: Embedding → PreNet → CBHG, then the speaker embedding is
concatenated to every character. Decoder iteration: PreNet → attention GRU →
location-sensitive attention (31-tap conv over the cumulative attention, 32
filters) → context → Linear → 2 residual LSTMs → r mel frames + stop token.
Postnet: CBHG → linear projection.

``decode_loop`` is the plain decoder (a Python loop of :func:`decoder_step`);
the generate path of the package runs the K2 kernel through
``ops.tacotron_decode`` instead. :func:`tacotron_forward` is the
teacher-forced training pass: everything that does not depend on the
recurrent state is hoisted out of the decoder loop, and the loop itself is
K5 (``ops.tacotron_train``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rtvc_tpu_torch.config.synthesizer import TacotronParams
from rtvc_tpu_torch.models.layers import (
    CBHG,
    Conv1d,
    Embedding,
    Linear,
    PreNet,
    gru_step,
    lstm_cell_step,
)
from rtvc_tpu_torch.ops.tacotron_train import prepare_train_weights, taco_decoder_train

Tensor = torch.Tensor


class TacotronDims(NamedTuple):
    """Static dimensions (same fields as the JAX package's TacotronDims)."""

    num_chars: int
    n_mels: int
    fft_bins: int
    speaker_embedding_size: int
    embed_dims: int
    encoder_dims: int
    decoder_dims: int
    postnet_dims: int
    encoder_K: int
    postnet_K: int
    num_highways: int
    lstm_dims: int
    max_r: int
    dropout: float
    stop_threshold: float

    @classmethod
    def from_config(cls, cfg: TacotronParams, num_chars: int, n_mels: int,
                    fft_bins: int, spk: int) -> "TacotronDims":
        return cls(
            num_chars=num_chars, n_mels=n_mels, fft_bins=fft_bins,
            speaker_embedding_size=spk, embed_dims=cfg.embed_dims,
            encoder_dims=cfg.encoder_dims, decoder_dims=cfg.decoder_dims,
            postnet_dims=cfg.postnet_dims, encoder_K=cfg.encoder_K,
            postnet_K=cfg.postnet_K, num_highways=cfg.num_highways,
            lstm_dims=cfg.lstm_dims, max_r=cfg.max_r, dropout=cfg.dropout,
            stop_threshold=cfg.stop_threshold,
        )

    @property
    def enc_out_dims(self) -> int:
        return self.encoder_dims + self.speaker_embedding_size


class Encoder(nn.Module):
    def __init__(self, d: TacotronDims, device=None):
        super().__init__()
        self.embedding = Embedding(d.num_chars, d.embed_dims, device=device)
        self.pre_net = PreNet(d.embed_dims, d.encoder_dims, d.encoder_dims,
                              d.dropout, device=device)
        self.cbhg = CBHG(d.encoder_K, d.encoder_dims, d.encoder_dims,
                         (d.encoder_dims, d.encoder_dims), d.num_highways,
                         device=device)


class LSA(nn.Module):
    """Location-sensitive attention parameters."""

    def __init__(self, d: TacotronDims, filters: int = 32, kernel_size: int = 31,
                 device=None):
        super().__init__()
        self.conv = Conv1d(1, filters, kernel_size, padding=(kernel_size - 1) // 2,
                           device=device)
        self.L = Linear(filters, d.decoder_dims, bias=False, device=device)
        self.W = Linear(d.decoder_dims, d.decoder_dims, device=device)
        self.v = Linear(d.decoder_dims, 1, bias=False, device=device)


class Decoder(nn.Module):
    def __init__(self, d: TacotronDims, device=None):
        super().__init__()
        D, L, E = d.decoder_dims, d.lstm_dims, d.enc_out_dims
        self.prenet = PreNet(d.n_mels, 2 * D, 2 * D, d.dropout, device=device)
        self.attn_net = LSA(d, device=device)
        self.attn_rnn = nn.GRUCell(E + 2 * D, D, device=device)
        self.rnn_input = Linear(E + D, L, device=device)
        self.res_rnn1 = nn.LSTMCell(L, L, device=device)
        self.res_rnn2 = nn.LSTMCell(L, L, device=device)
        self.mel_proj = Linear(L, d.n_mels * d.max_r, bias=False, device=device)
        self.stop_proj = Linear(L + E, 1, device=device)


class Tacotron(nn.Module):
    """Parameter container under the reference's state-dict names."""

    def __init__(self, d: TacotronDims, device=None):
        super().__init__()
        self.dims = d
        self.encoder = Encoder(d, device=device)
        self.encoder_proj = Linear(d.enc_out_dims, d.decoder_dims, bias=False,
                                   device=device)
        self.decoder = Decoder(d, device=device)
        self.postnet = CBHG(d.postnet_K, d.n_mels, d.postnet_dims,
                            (d.postnet_dims, d.fft_bins), d.num_highways,
                            device=device)
        self.post_proj = Linear(d.postnet_dims, d.fft_bins, bias=False,
                                device=device)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def encode(model: Tacotron, chars: Tensor, speaker_embedding: Tensor,
           generator: Optional[torch.Generator] = None,
           prenet_dropout: bool = True) -> Tuple[Tensor, Tensor]:
    """chars (B, T) → (encoder_seq (B, T, E), encoder_seq_proj (B, T, D)).
    The encoder prenet's dropout stays on unless ``prenet_dropout=False``."""
    enc = model.encoder
    x = enc.embedding(chars.long())
    x = enc.pre_net(x, generator, dropout=prenet_dropout)
    x = enc.cbhg(x)
    if speaker_embedding.ndim == 1:
        speaker_embedding = speaker_embedding[None, :]
    e = speaker_embedding[:, None, :].expand(x.shape[0], x.shape[1], -1)
    encoder_seq = torch.cat([x, e], dim=-1)
    return encoder_seq, model.encoder_proj(encoder_seq)


class DecoderCarry(NamedTuple):
    attn_hidden: Tensor
    rnn1_hidden: Tensor
    rnn1_cell: Tensor
    rnn2_hidden: Tensor
    rnn2_cell: Tensor
    context_vec: Tensor
    cumulative: Tensor  # (B, T_text) cumulative attention


def init_decoder_carry(d: TacotronDims, batch: int, t_text: int,
                       device=None) -> DecoderCarry:
    def z(n):
        return torch.zeros((batch, n), device=device)

    return DecoderCarry(z(d.decoder_dims), z(d.lstm_dims), z(d.lstm_dims),
                        z(d.lstm_dims), z(d.lstm_dims), z(d.enc_out_dims),
                        z(t_text))


def decoder_step(model: Tacotron, d: TacotronDims, r: int, carry: DecoderCarry,
                 prenet_in: Tensor, encoder_seq: Tensor, encoder_seq_proj: Tensor,
                 char_mask: Tensor, generator: Optional[torch.Generator] = None,
                 prenet_dropout: bool = True
                 ) -> Tuple[DecoderCarry, Tensor, Tensor, Tensor]:
    """One decoder iteration → (carry, mels (B, n_mels, r), scores (B, T),
    stop (B, 1))."""
    dec = model.decoder
    prenet_out = dec.prenet(prenet_in, generator, dropout=prenet_dropout)
    cell = dec.attn_rnn
    xg = (torch.cat([carry.context_vec, prenet_out], dim=-1) @ cell.weight_ih.t()
          + cell.bias_ih)
    attn_hidden = gru_step(xg, carry.attn_hidden, cell.weight_hh, cell.bias_hh)

    lsa = dec.attn_net
    processed_query = lsa.W(attn_hidden)[:, None, :]
    processed_loc = lsa.L(lsa.conv(carry.cumulative[:, :, None]))
    u = lsa.v(torch.tanh(processed_query + encoder_seq_proj + processed_loc))[..., 0]
    # the reference multiplies the logits by the pad mask (not an additive
    # mask), so pad characters take part in the softmax with logit 0
    u = u * char_mask
    scores = torch.softmax(u, dim=1)
    cumulative = carry.cumulative + scores
    context_vec = torch.einsum("bt,btc->bc", scores, encoder_seq)

    x = dec.rnn_input(torch.cat([context_vec, attn_hidden], dim=1))
    rnn1_hidden, rnn1_cell = lstm_cell_step(dec.res_rnn1, x, carry.rnn1_hidden,
                                            carry.rnn1_cell)
    x = x + rnn1_hidden
    rnn2_hidden, rnn2_cell = lstm_cell_step(dec.res_rnn2, x, carry.rnn2_hidden,
                                            carry.rnn2_cell)
    x = x + rnn2_hidden

    mels = dec.mel_proj(x).reshape(-1, d.n_mels, d.max_r)[:, :, :r]
    stop = torch.sigmoid(dec.stop_proj(torch.cat([x, context_vec], dim=1)))
    new_carry = DecoderCarry(attn_hidden, rnn1_hidden, rnn1_cell, rnn2_hidden,
                             rnn2_cell, context_vec, cumulative)
    return new_carry, mels, scores, stop


def decode_loop(model: Tacotron, d: TacotronDims, encoder_seq: Tensor,
                encoder_seq_proj: Tensor, char_mask: Tensor, r: int,
                max_steps: int, generator: Optional[torch.Generator] = None,
                prenet_dropout: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain decoder loop → (mel (B, n_mels, max_iters·r),
    attn (B, max_iters, T), stops (B, max_iters)), zero past the iteration
    where every stop token exceeded 0.5 (after step 10)."""
    B, T, _ = encoder_seq.shape
    dev = encoder_seq.device
    max_iters = max(max_steps // r, 1)
    mel = torch.zeros((B, d.n_mels, max_iters * r), device=dev)
    attn = torch.zeros((B, max_iters, T), device=dev)
    stops = torch.zeros((B, max_iters), device=dev)
    carry = init_decoder_carry(d, B, T, device=dev)
    prev = torch.zeros((B, d.n_mels), device=dev)
    for i in range(max_iters):
        carry, m, scores, stop = decoder_step(
            model, d, r, carry, prev, encoder_seq, encoder_seq_proj, char_mask,
            generator, prenet_dropout)
        mel[:, :, i * r:(i + 1) * r] = m
        attn[:, i] = scores
        stops[:, i] = stop[:, 0]
        prev = m[:, :, -1]
        if i * r > 10 and bool((stop > 0.5).all()):
            break
    return mel, attn, stops


def stop_iterations(stops: Tensor, r: int) -> int:
    """Iterations the decoder ran: the first where every stop token fired
    (past step 10), else all of them."""
    it = torch.arange(stops.shape[1], device=stops.device)
    fired = (stops > 0.5).all(dim=0) & (it * r > 10)
    if bool(fired.any()):
        return int(torch.argmax(fired.to(torch.int32))) + 1
    return stops.shape[1]


def postnet(model: Tacotron, mels: Tensor, lengths: Optional[Tensor] = None
            ) -> Tensor:
    """CBHG postnet + linear projection: mels (B, n_mels, L) → (B, L, fft_bins).
    ``lengths`` gives length-exact semantics on a padded buffer."""
    post = model.postnet(mels.transpose(1, 2), lengths=lengths)
    return model.post_proj(post)


def tacotron_generate(model: Tacotron, d: TacotronDims, chars: Tensor,
                      speaker_embedding: Tensor, r: int, seed: int,
                      max_steps: int = 2000, compute_linear: bool = False,
                      prenet_dropout: bool = True
                      ) -> Tuple[Tensor, Optional[Tensor], Tensor, int]:
    """Plain autoregressive generation → (mel (B, n_mels, max_iters·r),
    linear (B, fft_bins, L) or None, attn, n_valid_steps)."""
    g = torch.Generator(device=chars.device).manual_seed(seed)
    encoder_seq, encoder_seq_proj = encode(model, chars, speaker_embedding, g,
                                           prenet_dropout)
    char_mask = (chars != 0).to(torch.float32)
    mel, attn, stops = decode_loop(model, d, encoder_seq, encoder_seq_proj,
                                   char_mask, r, max_steps, g, prenet_dropout)
    n_valid = stop_iterations(stops, r) * r
    linear = None
    if compute_linear:
        lengths = torch.full((chars.shape[0],), n_valid, device=chars.device)
        linear = postnet(model, mel, lengths=lengths).transpose(1, 2)
    return mel, linear, attn, n_valid


# ---------------------------------------------------------------------------
# Teacher-forced training pass
# ---------------------------------------------------------------------------

# Zoneout probability of the residual LSTMs' hidden states in training.
ZONEOUT_P = 0.1


def draw_zoneout_masks(n_iters: int, batch: int, lstm_dims: int, device,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Two (n_iters, B, L) masks in {0, 1}: 1 (probability ``ZONEOUT_P``)
    keeps the previous hidden."""
    u = torch.rand((2, n_iters, batch, lstm_dims), generator=generator, device=device)
    zo = (u < ZONEOUT_P).to(torch.float32)
    return zo[0], zo[1]


def tacotron_forward(model: Tacotron, d: TacotronDims, chars: Tensor, mels: Tensor,
                     speaker_embedding: Tensor, r: int,
                     generator: Optional[torch.Generator] = None,
                     prenet_dropout: bool = True,
                     zoneout_masks: Optional[Tuple[Tensor, Tensor]] = None,
                     train: bool = True, encoder_prenet_dropout: bool = True
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Dict[str, Tensor]]:
    """Teacher-forced pass (``rtvc_tpu/models/tacotron.py:tacotron_forward``,
    its hoisted path). chars (B, T_text) int; mels (B, n_mels, steps) with
    steps % r == 0. Returns (mel_out (B, n_mels, steps), linear
    (B, fft_bins, steps), attn (B, steps // r, T_text), stop (B, steps),
    new_stats).

    The prenet runs over all teacher frames at once, the prenet half of the
    attention GRU's input projection is one matmul (``xg_pre``), and the mel
    and stop projections are applied to the stacked decoder states, the mel
    projection sliced to the ``r`` columns kept. What stays serial, attention
    and the three recurrent cells, is K5: the kernels on CUDA tensors, their
    plain versions on CPU tensors.

    With ``train`` (the default) the BatchNorms use batch statistics and
    ``new_stats`` maps each running-statistics buffer's name to its new value
    (the training step installs them), and zoneout masks (p = ``ZONEOUT_P``)
    are drawn from ``generator`` outside the kernel unless ``zoneout_masks``
    gives them. ``train=False`` is the alignment pass's mode, as the JAX
    package's: the BatchNorms use their running statistics, ``new_stats``
    stays empty and the zoneout masks are zero. The prenets' dropout stays on
    (the Tacotron 2 convention) unless turned off: ``prenet_dropout=False``
    the decoder prenet's, ``encoder_prenet_dropout=False`` the encoder
    prenet's. The GTA pass turns both off, as the JAX package's
    ``dropout=0.0`` does, so that its mels are deterministic. Under no grad
    the chain is one K5 forward launch, and autograd keeps no residual of it.
    """
    B, _, steps = mels.shape
    n_iters = steps // r
    enc, dec = model.encoder, model.decoder
    new_stats: Dict[str, Tensor] = {}
    batch_stats = new_stats if train else None
    x = enc.pre_net(enc.embedding(chars.long()), generator, dropout=encoder_prenet_dropout)
    x = enc.cbhg(x, new_stats=batch_stats, prefix="encoder.cbhg.")
    if speaker_embedding.ndim == 1:
        speaker_embedding = speaker_embedding[None, :]
    e = speaker_embedding[:, None, :].expand(x.shape[0], x.shape[1], -1)
    encoder_seq = torch.cat([x, e], dim=-1)
    encoder_seq_proj = model.encoder_proj(encoder_seq)
    char_mask = (chars != 0).to(torch.float32)

    # teacher inputs: frame t-1 for t = 0, r, 2r, ... (a zero frame at t = 0)
    teacher_idx = torch.arange(1, n_iters, device=mels.device) * r - 1
    teacher = torch.cat([mels.new_zeros((B, 1, d.n_mels)),
                         mels[:, :, teacher_idx].transpose(1, 2)], dim=1)
    prenet_all = dec.prenet(teacher, generator, dropout=prenet_dropout)
    E = encoder_seq.shape[-1]
    cell = dec.attn_rnn
    xg_pre = prenet_all @ cell.weight_ih[:, E:].t() + cell.bias_ih  # (B, n_iters, 3D)

    if zoneout_masks is None and train:
        zoneout_masks = draw_zoneout_masks(n_iters, B, d.lstm_dims, mels.device, generator)
    elif zoneout_masks is None:
        zero = mels.new_zeros((n_iters, B, d.lstm_dims))
        zoneout_masks = (zero, zero)
    x_all, ctx_all, attn = taco_decoder_train(
        prepare_train_weights(dec, E), xg_pre.transpose(0, 1), encoder_seq, encoder_seq_proj,
        char_mask, *zoneout_masks)

    # mel_proj keeps only the columns j with j % max_r < r
    keep = (torch.arange(d.n_mels, device=mels.device)[:, None] * d.max_r
            + torch.arange(r, device=mels.device)).reshape(-1)
    mel_steps = (x_all @ dec.mel_proj.weight[keep].t()).reshape(n_iters, B, d.n_mels, r)
    stops = torch.sigmoid(dec.stop_proj(torch.cat([x_all, ctx_all], dim=-1)))  # (n_iters, B, 1)
    mel_out = mel_steps.permute(1, 2, 0, 3).reshape(B, d.n_mels, steps)
    stop_out = stops[..., 0].transpose(0, 1).repeat_interleave(r, dim=1)
    post = model.postnet(mel_out.transpose(1, 2), new_stats=batch_stats, prefix="postnet.")
    linear = model.post_proj(post).transpose(1, 2)
    return mel_out, linear, attn.transpose(0, 1), stop_out, new_stats
