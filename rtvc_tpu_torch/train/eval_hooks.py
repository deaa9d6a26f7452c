"""The trainers' evaluation hooks (counterpart of
``rtvc_tpu/train/eval_hooks.py``):

* Tacotron: a generated sample (K2 on the card) as an attention plot, a mel
  plot and a Griffin-Lim wav;
* ForwardTacotron and FastPitch: a generated mel plot and Griffin-Lim wav,
  and the pitch and energy sweeps (× 0.5, 1.0, 1.5);
* the speaker encoder: a t-SNE projection of a batch's embeddings, one
  colour a speaker (plot only).

A synthesizer hook is ``hook(step, model, r)`` on the model being trained:
it takes no gradient, reads the running statistics without writing them,
draws its noise from generators of its own (seeded by the step), and
restores the model's mode. Plots are written where matplotlib imports
(``utils.plots``); the wavs always.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.ops.audio import inv_mel_spectrogram
from rtvc_tpu_torch.text import text_to_sequence
from rtvc_tpu_torch.utils import plots
from rtvc_tpu_torch.utils.io import save_wav

DEFAULT_TEXTS = ("this is an evaluation sample.",)
# the hooks pad their texts to a multiple of this many characters
CHAR_BUCKET = 16
SWEEP = (0.5, 1.0, 1.5)


def default_embeds(n: int = 1) -> np.ndarray:
    """``n`` copies of one seeded unit 768-d speaker embedding."""
    e = np.random.default_rng(0).standard_normal(768).astype(np.float32)
    return np.stack([e / np.linalg.norm(e)] * n)


def hook_chars(texts: Sequence[str]) -> np.ndarray:
    """Texts → character ids (B, T), padded with 0 to ``CHAR_BUCKET``."""
    seqs = [text_to_sequence(t, preprocessing.cleaner_names) for t in texts]
    chars = np.zeros((len(seqs), -(-max(len(s) for s in seqs) // CHAR_BUCKET) * CHAR_BUCKET),
                     np.int64)
    for i, s in enumerate(seqs):
        chars[i, :len(s)] = s
    return chars


def griffin_lim_wav(mel: torch.Tensor, gl_iters: int, seed: int = 0) -> np.ndarray:
    """A normalised mel (n_mels, T) on any device → a waveform on the host."""
    g = torch.Generator(device=mel.device).manual_seed(seed)
    pp = preprocessing.replace(griffin_lim_iters=gl_iters)
    return inv_mel_spectrogram(mel, sp, pp, g).cpu().numpy()


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """Inside: the model in eval mode and no gradient; after: its mode
    restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def make_tacotron_eval_hook(out_dir, texts: Sequence[str] = DEFAULT_TEXTS,
                            embeds: Optional[np.ndarray] = None, gl_iters: int = 30,
                            max_steps: int = 400):
    """``hook(step, model, r)``: generates the first text with the Tacotron
    ``model`` (the K2 decoder at B 1, up to ``(max_steps // r) * r`` frames,
    prenet dropout drawn from the step's seed) and writes
    ``attention_{step}.png``, ``mel_{step}.png`` and ``eval_{step}.wav``
    (Griffin-Lim of the decoder's mel) into ``out_dir``."""
    from rtvc_tpu_torch.models import tacotron as taco
    from rtvc_tpu_torch.ops import tacotron_decode as k2

    out_dir = Path(out_dir)
    chars_np = hook_chars(texts[:1])
    embeds = default_embeds() if embeds is None else np.asarray(embeds, np.float32)[:1]

    def hook(step: int, model, r: int):
        dev = model.post_proj.weight.device
        with eval_mode(model):
            chars = torch.as_tensor(chars_np, device=dev)
            g = torch.Generator(device=dev).manual_seed(step)
            enc_seq, enc_proj = taco.encode(model, chars, torch.as_tensor(embeds, device=dev), g)
            mel, attn, stops = k2.tacotron_decode(model, model.dims, enc_seq.contiguous(),
                                                  enc_proj.contiguous(), (chars != 0).float(),
                                                  step, r, (max_steps // r) * r)
            n = max(taco.stop_iterations(stops, r) * r, r)
            mel0 = mel[0, :, :n]
            wav = griffin_lim_wav(mel0, gl_iters)
        out_dir.mkdir(parents=True, exist_ok=True)
        plots.save_attention(attn[0, :n // r].cpu().numpy(), out_dir / f"attention_{step}",
                             f"step {step}")
        plots.save_spectrogram(mel0.cpu().numpy(), out_dir / f"mel_{step}", f"step {step}")
        save_wav(wav, out_dir / f"eval_{step}.wav", sp.sample_rate)

    return hook


def make_encoder_projection_hook(out_dir, speakers_per_batch: int):
    """``hook(step, embeds)``: embeds (S·U, E) → ``projection_{step}.png``, a
    t-SNE scatter with one colour a speaker; nothing where matplotlib does
    not import."""
    from rtvc_tpu_torch.utils.projection import project_2d

    out_dir = Path(out_dir)

    def hook(step: int, embeds: np.ndarray):
        if not plots.available():
            return
        plots.save_scatter(project_2d(np.asarray(embeds)), speakers_per_batch,
                           out_dir / f"projection_{step}",
                           f"embedding projection @ step {step}")

    return hook


def make_nar_eval_hook(out_dir, model_type: str, texts: Sequence[str] = DEFAULT_TEXTS,
                       embeds: Optional[np.ndarray] = None, gl_iters: int = 30):
    """``hook(step, model, r)`` for ForwardTacotron or FastPitch (``r`` is
    not read): generates the first text and writes ``mel_{step}.png`` and
    ``eval_{step}.wav`` (Griffin-Lim of the mel cut at the durations' sum),
    then generates it with the predicted pitch, and apart the predicted
    energy, scaled by each factor of ``SWEEP`` and plots each mel's mean
    over the mel bands, frame by frame: ``pitch_sweep_{step}.png`` and
    ``energy_sweep_{step}.png``."""
    from rtvc_tpu_torch.models.fast_pitch import fastpitch_generate
    from rtvc_tpu_torch.models.forward_tacotron import forward_generate

    gen = (forward_generate if model_type == factories.MODEL_TYPE_FORWARD_TACOTRON
           else fastpitch_generate)
    out_dir = Path(out_dir)
    chars_np = hook_chars(texts[:1])
    embeds = default_embeds() if embeds is None else np.asarray(embeds, np.float32)[:1]

    def hook(step: int, model, r: int):
        dev = next(model.parameters()).device
        chars, spk = torch.as_tensor(chars_np, device=dev), torch.as_tensor(embeds, device=dev)
        with eval_mode(model):
            mel, durs = gen(model, chars, spk)
            mel0 = mel[0, :, :max(int(durs[0].sum()), 1)]
            wav = griffin_lim_wav(mel0, gl_iters)
            pitch_rows, energy_rows = [], []
            for factor in SWEEP:
                m_p, _ = gen(model, chars, spk, pitch_function=lambda p, f=factor: p * f)
                m_e, _ = gen(model, chars, spk, energy_function=lambda p, f=factor: p * f)
                pitch_rows.append(m_p[0].mean(dim=0).cpu().numpy())
                energy_rows.append(m_e[0].mean(dim=0).cpu().numpy())
        out_dir.mkdir(parents=True, exist_ok=True)
        plots.save_spectrogram(mel0.cpu().numpy(), out_dir / f"mel_{step}", f"step {step}")
        save_wav(wav, out_dir / f"eval_{step}.wav", sp.sample_rate)
        labels = [f"×{f}" for f in SWEEP]
        plots.save_series_grid(pitch_rows, labels, out_dir / f"pitch_sweep_{step}",
                               f"pitch modifier sweep @ {step}")
        plots.save_series_grid(energy_rows, labels, out_dir / f"energy_sweep_{step}",
                               f"energy modifier sweep @ {step}")

    return hook


def make_synthesizer_eval_hook(out_dir, model_type: str):
    """The evaluation hook of a synthesizer type, as the entry points wire
    it."""
    if model_type == factories.MODEL_TYPE_TACOTRON:
        return make_tacotron_eval_hook(out_dir)
    return make_nar_eval_hook(out_dir, model_type)
