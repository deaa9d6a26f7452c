"""Streaming voice cloning (counterpart of ``rtvc_tpu/inference/streaming.py``):
the first audio after one chunk of the decode instead of after the whole
utterance.

:func:`stream_clone` runs the Tacotron decoder in chunks of iterations (the
K2 kernel resumed from a carried decoder state, ``ops.tacotron_decode.
tacotron_decode_chunk``), runs the postnet over each chunk with ``post_ctx``
raw frames of left context (the CBHG length-limited to the valid frames), and
vocodes each chunk with ``voc_ctx`` frames of already-emitted conditioning
before it, so that the sample loop has warmed up at the splice; the chunks'
waveforms are joined with an equal-power crossfade and the stream ends with
the batch path's 20-hop fade. :func:`stream_vocode` streams an already
complete mel through the same chunked vocoder (the vocode-only route).

The schedule, the trims and the crossfades are the JAX package's, step for
step. The decoder takes the seed ``Synthesizer.synthesize_spectrograms``
takes (its encoder dropout and K2's noise, keyed by the absolute iteration),
so the streamed raw decoder frames equal the batch path's; only the chunked
postnet differs (it lacks right context at the live edge). Each chunk's
vocoder seed is :func:`chunk_seed` ``(voc_seed, index)``, derived from
``voc_seed ^ 0x5EED`` and the chunk's index (:func:`derive_seed`), as the
JAX package folds the index into ``PRNGKey(seed ^ 0x5EED)``.

The context buffers stay on the device. The vocoder's sample loop takes
``stream_dtype`` and ``compute_dtype`` keywords, as the JAX functions do;
both default to f32, as ``inference.vocoder``'s options do (the JAX
package's stream default, bf16, is a choice made for its TPU kernel). The
non-autoregressive
synthesizers (ForwardTacotron, FastPitch) make their whole mel in one
parallel pass, so their stream is that mel through :func:`stream_vocode`,
as in the JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from rtvc_tpu_torch.config import sp as _sp
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as taco
from rtvc_tpu_torch.models.wavernn import generate_pipeline
from rtvc_tpu_torch.ops.tacotron_decode import DecodeChunk, tacotron_decode_chunk

Tensor = torch.Tensor


@dataclass
class StreamChunk:
    wav: np.ndarray   # float32 samples, crossfaded, ready to play
    index: int        # chunk number, 0-based
    final: bool       # True on the last chunk
    t_emitted: float  # time.perf_counter() when this chunk was ready
    frames: int = 0   # mel frames this chunk adds: Σ frames · hop − hop samples in all


def derive_seed(seed: int, index: int) -> int:
    """The 64-bit seed of draw ``index`` of a call seeded ``seed``: ``seed``
    folded to 32 bits in the high half, and spread and offset by the index
    in the low half, so that both halves change with the call and with the
    index (K1's Philox reads all 64 bits, the plain version's generator the
    low 32)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    s = (s ^ (s >> 32)) & 0xFFFFFFFF
    return (s << 32) | ((s * 0x9E3779B1 + int(index)) & 0xFFFFFFFF)


def chunk_seed(voc_seed: int, index: int) -> int:
    """The vocoder seed of chunk ``index`` of a stream."""
    return derive_seed(int(voc_seed) ^ 0x5EED, index)


def _vocoder(voc):
    """The vocoder bundle to stream with: ``voc``, else the one installed in
    ``inference.vocoder``."""
    if voc is not None:
        return voc
    from rtvc_tpu_torch.inference import vocoder

    if vocoder._bundle is None:
        raise Exception("Please load Wave-RNN in memory before using it")
    return vocoder._bundle


def vocode_window(voc, cond: Tensor, seed: int, target: int, overlap: int,
                  compute_dtype=torch.float32, stream_dtype=torch.float32) -> Tensor:
    """One conditioning window (n_mels, W) in the synthesizer's scale → the
    generate path's samples on the device, untrimmed (the first (W − 1)·hop
    are the window's): one K1 launch on a card, at the two dtypes. mu-law
    decoding and de-emphasis follow the vocoder's config and the signal
    config, as in ``vocoder.infer_waveform``."""
    return generate_pipeline(voc.model, voc.dims, cond[None] / _sp.max_abs_value, seed, True,
                             target, overlap, voc.config.mu_law, _sp.preemphasize,
                             compute_dtype=compute_dtype, stream_dtype=stream_dtype)


class _HostCopy:
    """The first ``n`` samples of a device waveform copied to the host
    behind the work queued so far: on a card an asynchronous copy into
    pinned memory and an event, so that work queued after it (the next
    chunk's decode) does not delay it; on the CPU the samples themselves."""

    def __init__(self, wav: Tensor, n: int):
        wav = wav[:n]
        if wav.is_cuda:
            self._host = torch.empty(wav.shape, dtype=wav.dtype, pin_memory=True)
            self._host.copy_(wav, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = wav, None

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


class _Joiner:
    """The host side of a stream: each chunk's window trimmed to its body,
    the equal-power crossfade over ``xfade`` samples at each join (the
    previous chunk's last ``xfade`` samples held back), and the 20-hop fade
    at the end."""

    def __init__(self, xfade: int, hop: int):
        self.xfade, self.hop = xfade, hop
        self.tail: Optional[np.ndarray] = None

    def __call__(self, body: np.ndarray, final: bool) -> np.ndarray:
        xfade = self.xfade
        if self.tail is not None and xfade and len(body) >= xfade:
            ramp = np.sin(0.5 * np.pi * np.linspace(0, 1, xfade)) ** 2
            body = body.copy()
            body[:xfade] = self.tail * (1.0 - ramp) + body[:xfade] * ramp
        out, self.tail = (body[:-xfade], body[-xfade:]) if xfade else (body, None)
        if final:
            if self.tail is not None:
                out = np.concatenate([out, self.tail])
                self.tail = None
            out = out.copy()
            fade_len = min(20 * self.hop, len(out))
            if fade_len:
                out[-fade_len:] *= np.linspace(1.0, 0.0, fade_len)
        return out


def vocode_schedule(T: int, chunk_frames: int, first_chunk_frames: Optional[int],
                    xfade_frames: int, voc_ctx: int) -> Tuple[List[int], List[int]]:
    """The chunks (starts, sizes) :func:`stream_vocode` cuts a T-frame mel
    into: ``first`` frames, then ``chunk_frames`` at a time, a tail shorter
    than max(2, xfade_frames + 1) merged into the chunk before it."""
    chunk_frames = max(chunk_frames, voc_ctx + 1)
    first = min(first_chunk_frames or chunk_frames, chunk_frames)
    # the second chunk's context is the first chunk's tail: the first chunk
    # must cover the boundary frame and the crossfade's lead-in
    first = max(first, 1 + xfade_frames, 2)
    starts, sizes = [], []
    pos = 0
    while pos < T:
        n = min(first if pos == 0 else chunk_frames, T - pos)
        starts.append(pos)
        sizes.append(n)
        pos += n
    if len(sizes) > 1 and sizes[-1] < max(2, xfade_frames + 1):
        sizes[-2] += sizes[-1]
        starts.pop()
        sizes.pop()
    return starts, sizes


@torch.no_grad()
def stream_vocode(voc, mel: np.ndarray, seed: int = 0, chunk_frames: int = 48,
                  voc_ctx: int = 12, xfade_frames: int = 2, voc_target: int = 400,
                  voc_overlap: int = 160, first_chunk_frames: Optional[int] = None,
                  stream_dtype=torch.float32, compute_dtype=torch.float32
                  ) -> Iterator[StreamChunk]:
    """Chunked vocoding of a complete mel (n_mels, T) in the synthesizer's
    scale with the vocoder bundle ``voc`` (None: the installed one): yields
    playable chunks with ``voc_ctx`` frames of conditioning before every
    splice and an equal-power crossfade at the joins, (T − 1)·hop samples in
    all, as ``vocoder.infer_waveform`` gives for the same mel. Chunk i+1's
    vocode is launched before the host takes chunk i's samples. Each chunk's
    K1 launch takes ``stream_dtype`` and ``compute_dtype``."""
    voc = _vocoder(voc)
    hop = voc.dims.hop_length
    xfade_frames = max(xfade_frames, 0)
    voc_ctx = max(voc_ctx, 1 + xfade_frames)  # the invariant stream_clone keeps
    mel = np.asarray(mel, np.float32)
    T = mel.shape[1]
    if T < 2:
        return
    starts, sizes = vocode_schedule(T, chunk_frames, first_chunk_frames, xfade_frames, voc_ctx)
    mel_dev = torch.as_tensor(mel, device=voc.model.I.weight.device)
    join = _Joiner(xfade_frames * hop, hop)

    def dispatch(i):
        s, n = starts[i], sizes[i]
        lo = max(s - voc_ctx, 0)
        wav = vocode_window(voc, mel_dev[:, lo:s + n], chunk_seed(seed, i), voc_target,
                            voc_overlap, compute_dtype, stream_dtype)
        return _HostCopy(wav, (s + n - lo - 1) * hop)

    pending = dispatch(0)
    for i in range(len(starts)):
        copy = pending
        if i + 1 < len(starts):
            pending = dispatch(i + 1)  # on the card before this chunk's samples reach the host
        wav = copy.numpy()
        s, n = starts[i], sizes[i]
        ctx = min(voc_ctx, s)  # the first chunk has no left context
        # a (ctx + n)-frame window decodes (ctx + n − 1)·hop samples: drop the
        # context less the crossfade's lead-in; each chunk ends a frame short,
        # which the next chunk's context decodes again
        if i == 0:
            cut, end = 0, (n - 1) * hop
        else:
            cut, end = max((ctx - 1) * hop - join.xfade, 0), (ctx - 1 + n) * hop
        final = i == len(starts) - 1
        out = join(wav[cut:end], final)
        yield StreamChunk(wav=out, index=i, final=final, t_emitted=time.perf_counter(),
                          frames=n)


class _ChunkPost:
    """A chunk's postnet and vocode, the context buffers on the device:
    the postnet over [raw context | chunk] (length-limited to the context
    and the chunk's valid frames, so that the pad past the stop does not
    reach the kept frames through the CBHG's reverse GRU), then the vocoder
    over [postnet context | postnet chunk]."""

    def __init__(self, model, voc, post_ctx: int, voc_ctx: int, pad_value: float, n_mels: int,
                 dev, voc_target: int, voc_overlap: int,
                 dtypes: Tuple = (torch.float32, torch.float32)):
        self.model, self.voc = model, voc
        self.post_ctx, self.voc_ctx = post_ctx, voc_ctx
        self.raw_hist = torch.full((n_mels, post_ctx), pad_value, device=dev)
        self.post_hist = torch.full((n_mels, voc_ctx), pad_value, device=dev)
        self.window = (voc_target, voc_overlap, *dtypes)

    def postnet(self, mel_chunk: Tensor, valid_frames: int) -> Tensor:
        """(n_mels, n) of postnet frames for the chunk's (1, n_mels, n) raw
        frames; moves the raw context on."""
        win = torch.cat([self.raw_hist, mel_chunk[0]], dim=1)
        lengths = torch.tensor([self.post_ctx + valid_frames], device=win.device)
        post = taco.postnet(self.model, win[None], lengths)[0].t()
        self.raw_hist = win[:, win.shape[1] - self.post_ctx:]
        return post[:, self.post_ctx:]

    def vocode(self, post_chunk: Tensor, seed: int) -> Tensor:
        """The window [postnet context | chunk] vocoded on the device; moves
        the postnet context on."""
        cond = torch.cat([self.post_hist, post_chunk], dim=1)
        self.post_hist = cond[:, cond.shape[1] - self.voc_ctx:]
        return vocode_window(self.voc, cond, seed, *self.window)


@torch.no_grad()
def stream_clone(synth, voc, text: str, embed: np.ndarray, seed: int = 0,
                 chunk_frames: int = 48, post_ctx: int = 32, voc_ctx: int = 12,
                 xfade_frames: int = 2, voc_target: int = 400, voc_overlap: int = 160,
                 min_frames: int = 0, first_chunk_frames: Optional[int] = None,
                 voc_seed: Optional[int] = None, stream_dtype=torch.float32,
                 compute_dtype=torch.float32) -> Iterator[StreamChunk]:
    """Clone ``text`` in ``embed``'s voice, yielding playable chunks of
    ``chunk_frames`` mel frames (rounded up to a multiple of r; 0.6 s at the
    default hop). ``synth`` is a ``Synthesizer`` with its model, ``voc`` a
    vocoder bundle (None: the one installed in ``inference.vocoder``).

    A ForwardTacotron or FastPitch ``synth`` makes the whole mel with
    ``synthesize_spectrograms(..., seed=seed)`` and streams it through
    :func:`stream_vocode` (``post_ctx`` and ``min_frames`` do not apply).

    ``first_chunk_frames`` ramps the stream: a smaller first chunk (16 frames:
    0.2 s of audio) shortens the first chunk's decode and vocode while the
    later chunks run at ``chunk_frames``. ``min_frames`` holds the stop token
    off until that many frames. The decoder draws from ``seed``, as
    ``synthesize_spectrograms(..., seed=seed)`` does; the vocoder's chunks
    from ``voc_seed`` (``seed`` unless given; :func:`chunk_seed`), its K1
    launches at ``stream_dtype`` and ``compute_dtype``.

    The stream's waveform has (Σ frames − 1)·hop samples, Σ frames the valid
    decoder frames, as the batch clone of the same frames has; like the
    batch decode it stops at ``max_decoder_steps`` (the JAX package's
    stream runs its last chunk whole, up to chunk_frames − r frames past
    it). The decode of
    chunk i+1 is launched before the host takes chunk i's audio: the card
    runs one stream of work, so the copy of chunk i's samples and the host's
    crossfade overlap chunk i+1's decode rather than wait for it."""
    voc_seed = seed if voc_seed is None else voc_seed
    if synth.get_model_type() != factories.MODEL_TYPE_TACOTRON:
        mel = synth.synthesize_spectrograms([text], [np.asarray(embed, np.float32)],
                                            seed=seed)[0]
        yield from stream_vocode(voc, mel, voc_seed, chunk_frames, voc_ctx, xfade_frames,
                                 voc_target, voc_overlap, first_chunk_frames,
                                 stream_dtype=stream_dtype, compute_dtype=compute_dtype)
        return
    from rtvc_tpu_torch.inference.synthesizer import text_ids

    voc = _vocoder(voc)
    bundle = synth._bundle
    d, model, r = bundle.dims, bundle.model, synth._r
    dev = model.post_proj.weight.device
    chunk_frames = -(-chunk_frames // r) * r
    chunk_iters = chunk_frames // r
    max_iters = bundle.config.max_decoder_steps // r
    hop = voc.dims.hop_length
    pad_value = -float(_sp.max_abs_value)
    post_ctx = max(post_ctx, 0)
    xfade_frames = max(xfade_frames, 0)
    # voc_ctx ≥ 1 + xfade_frames: a W-frame window decodes (W − 1)·hop
    # samples, so the next chunk's context decodes each chunk's last frame
    # again, and the crossfade's lead-in must lie inside the context; below
    # that the cut drops samples at every join and the stream runs short of
    # (Σ valid − 1)·hop
    voc_ctx = max(voc_ctx, 1 + xfade_frames)
    first_iters = max(-(-first_chunk_frames // r), 1) if first_chunk_frames else chunk_iters

    def chunk_iters_at(index, start):
        # the last chunk stops at max_decoder_steps, as the batch decode does
        return min(first_iters if index == 0 else chunk_iters, max_iters - start)

    chars = text_ids([text])
    enc_seq, enc_proj, mask = synth.encode(chars, np.asarray(embed, np.float32)[None], seed)
    # the plain decoder's dropout draws continue from chunk to chunk, as in
    # one decode_loop (the kernel keys its noise by the iteration instead)
    g_dec = torch.Generator(device=dev).manual_seed(seed)
    min_iters = min_frames // r

    def decode(carry, prev, done, start, n_iters) -> DecodeChunk:
        return tacotron_decode_chunk(model, d, enc_seq, enc_proj, mask, seed, r, carry, prev,
                                     done, start, n_iters, min_iters, pad_value, True, g_dec)

    post = _ChunkPost(model, voc, post_ctx, voc_ctx, pad_value, d.n_mels, dev, voc_target,
                      voc_overlap, (compute_dtype, stream_dtype))
    join = _Joiner(xfade_frames * hop, hop)
    start_i, index = 0, 0
    pending = decode(taco.init_decoder_carry(d, 1, chars.shape[1], device=dev),
                     torch.zeros((1, d.n_mels), device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev), 0, chunk_iters_at(0, 0))
    while start_i < max_iters:
        n_iters = chunk_iters_at(index, start_i)
        n_frames = n_iters * r
        out = pending
        valid_frames = int(out.valid) * r  # waits for this chunk's decode
        is_final = bool(out.done) or start_i + n_iters >= max_iters
        if valid_frames == 0:
            break
        wav_dev = post.vocode(post.postnet(out.mel, valid_frames), chunk_seed(voc_seed, index))
        W = voc_ctx + n_frames
        copy = _HostCopy(wav_dev, (W - 1) * hop)
        if not is_final:
            pending = decode(out.carry, out.prev, out.done, start_i + n_iters,
                             chunk_iters_at(index + 1, start_i + n_iters))
        wav = copy.numpy()
        # a window of F frames decodes (F − 1)·hop samples, so each chunk ends
        # a frame short and the next chunk's context decodes that frame again
        # (cut at (voc_ctx − 1)·hop); the first chunk's context is the
        # silence pad, cut whole
        if index == 0:
            cut, end = voc_ctx * hop, (voc_ctx + valid_frames - 1) * hop
        else:
            cut = max((voc_ctx - 1) * hop - join.xfade, 0)
            end = (voc_ctx - 1 + valid_frames) * hop
        yield StreamChunk(wav=join(wav[cut:end], is_final), index=index, final=is_final,
                          t_emitted=time.perf_counter(), frames=valid_frames)
        index += 1
        start_i += n_iters
        if is_final:
            break
