"""Plain GE2E speaker encoder with its front end: volume normalisation,
the silence trim, the 40-channel power mel (librosa's Slaney filterbank,
centred reflect-padded STFT with a periodic Hann window), the 160-frame
partials at half overlap, three LSTM layers, a linear layer with ReLU, the
L2 normalisation, the mean of the partials renormalised; and the GE2E
training step (similarity matrix, softmax loss, the scale's gradients
× 0.01, clip to 3, Adam).

The silence trim is the fork's: an energy detector over 30 ms windows,
smoothed by a moving average of 8 and dilated by 7 windows, as the
program's host-side preprocessing does it (numpy, float64).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.reference.nn import Prec, Weights, lstm_cell

Tensor = torch.Tensor

SR = 16000
N_FFT = 400      # 25 ms
HOP = 160        # 10 ms
N_MELS = 40
PARTIAL = 160
TARGET_DBFS = -30.0
VAD_WINDOW_MS = 30
VAD_AVERAGE = 8
VAD_MAX_SILENCE = 6


def normalize_volume(wav: np.ndarray) -> np.ndarray:
    """Raise (never lower) the level to -30 dBFS."""
    change = TARGET_DBFS - 10.0 * np.log10(np.mean(wav.astype(np.float64) ** 2))
    return wav * max(10.0 ** (change / 20.0), 1.0)


def _speech_windows(wav: np.ndarray) -> np.ndarray:
    n = (VAD_WINDOW_MS * SR) // 1000
    frames = wav[:len(wav) // n * n].reshape(-1, n).astype(np.float64)
    db = 10.0 * np.log10(np.maximum(np.mean(frames ** 2, axis=1), 1e-12))
    threshold = max(min(np.percentile(db, 10.0) + 12.0, np.percentile(db, 95) - 30.0), -70.0)
    return db > threshold


def trim_long_silences(wav: np.ndarray) -> np.ndarray:
    n = (VAD_WINDOW_MS * SR) // 1000
    wav = wav[:len(wav) - len(wav) % n]
    if len(wav) == 0:
        return wav
    flags = _speech_windows(wav).astype(float)
    w = VAD_AVERAGE
    padded = np.concatenate((np.zeros((w - 1) // 2), flags, np.zeros(w // 2)))
    ret = np.cumsum(padded, dtype=float)
    ret[w:] = ret[w:] - ret[:-w]
    mask = np.round(ret[w - 1:] / w).astype(bool)
    mask = np.convolve(mask.astype(int), np.ones(VAD_MAX_SILENCE + 1, dtype=int), "same") > 0
    return wav[np.repeat(mask, n)]


def preprocess(wav: np.ndarray) -> np.ndarray:
    return trim_long_silences(normalize_volume(np.asarray(wav, np.float32))).astype(np.float32)


@functools.lru_cache(maxsize=4)
def mel_basis(sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MELS) -> np.ndarray:
    """librosa's Slaney-normalised triangular filterbank, (n_mels, 1 + n_fft/2)."""
    f_sp, min_hz = 200.0 / 3.0, 1000.0
    min_mel, step = min_hz / f_sp, np.log(6.4) / 27.0

    def hz2mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_hz, min_mel + np.log(np.maximum(f, 1e-10) / min_hz) / step,
                        f / f_sp)

    def mel2hz(m):
        return np.where(m >= min_mel, min_hz * np.exp(step * (m - min_mel)), f_sp * m)

    fft_f = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel2hz(np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]


def mel_frames(wav: np.ndarray) -> np.ndarray:
    """Power mel frames (T, 40), T = 1 + len // 160."""
    y = np.pad(wav.astype(np.float64), N_FFT // 2, mode="reflect")
    n = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(n)[:, None] * HOP + np.arange(N_FFT)[None, :]
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)
    power = np.abs(np.fft.rfft(y[idx] * win, n=N_FFT, axis=-1)) ** 2
    return (power @ mel_basis().T).astype(np.float32)


def partial_slices(n_samples: int) -> List[slice]:
    """160-frame windows every 80 frames; the last kept only if it covers at
    least 75 % of itself, or it is the only one."""
    n_frames = int(np.ceil((n_samples + 1) / HOP))
    step = PARTIAL // 2
    starts = range(0, max(1, n_frames - PARTIAL + step + 1), step)
    slices = [slice(s, s + PARTIAL) for s in starts]
    coverage = (n_samples - slices[-1].start * HOP) / (PARTIAL * HOP)
    if coverage < 0.75 and len(slices) > 1:
        slices = slices[:-1]
    return slices


def forward(P: Prec, W: Weights, c: dict, frames: Tensor) -> Tensor:
    """Mel frames (B, T, 40) → L2-normalised embeddings (B, E)."""
    x = frames
    for k in range(c["layers"]):
        xg = P.linear(x, W[f"lstm.weight_ih_l{k}"]) + (W[f"lstm.bias_ih_l{k}"]
                                                      + W[f"lstm.bias_hh_l{k}"])
        w_hh = W[f"lstm.weight_hh_l{k}"]
        h = x.new_zeros((x.shape[0], w_hh.shape[1]))
        cc = torch.zeros_like(h)
        out = []
        for t in range(x.shape[1]):
            h, cc = lstm_cell(P, xg[:, t], h, cc, w_hh)
            out.append(h)
        x = torch.stack(out, dim=1)
    e = torch.relu(P.linear(h, W["linear.weight"], W["linear.bias"]))
    return e / torch.linalg.norm(e, dim=1, keepdim=True)


@torch.no_grad()
def embed_utterance(P: Prec, W: Weights, c: dict, wav: np.ndarray) -> np.ndarray:
    """A prompt as recorded → its embedding (E,), float64 on the host."""
    wav = preprocess(wav)
    slices = partial_slices(len(wav))
    need = slices[-1].stop * HOP
    if need >= len(wav):
        wav = np.pad(wav, (0, need - len(wav)))
    frames = mel_frames(wav)
    batch = torch.as_tensor(np.stack([frames[s] for s in slices]), device=W["linear.weight"].device)
    partial = forward(P, W, c, batch).double().cpu().numpy()
    raw = partial.mean(axis=0)
    return raw / np.linalg.norm(raw)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def ge2e_loss(embeds: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """GE2E softmax loss of embeds (S, U, E): the cosine of each utterance
    with every speaker's centroid (its own speaker's without it), × w + b."""
    S, U, _ = embeds.shape
    incl = embeds.mean(dim=1)
    incl = incl / (torch.linalg.norm(incl, dim=1, keepdim=True) + 1e-5)
    excl = (embeds.sum(dim=1, keepdim=True) - embeds) / (U - 1)
    excl = excl / (torch.linalg.norm(excl, dim=2, keepdim=True) + 1e-5)
    sim = torch.einsum("jue,ke->juk", embeds, incl)
    own = (embeds * excl).sum(dim=2)
    eye = torch.eye(S, dtype=torch.bool, device=embeds.device)[:, None, :]
    sim = torch.where(eye, own[:, :, None], sim) * w + b
    targets = torch.arange(S, device=embeds.device).repeat_interleave(U)
    return torch.nn.functional.cross_entropy(sim.reshape(S * U, S), targets)


def encoder_train_step(P: Prec, W: Weights, c: dict, opt: "Adam", inputs: Tensor, S: int,
                       U: int) -> Tuple[float, Dict[str, Tensor]]:
    """One GE2E step on trainable leaves ``W`` (requires_grad) → (loss, the
    gradients the optimizer applied)."""
    embeds = forward(P, W, c, inputs).reshape(S, U, -1)
    loss = ge2e_loss(embeds, W["similarity_weight"], W["similarity_bias"])
    names = [k for k, v in W.items() if v.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(loss, [W[k] for k in names])))
    for k in ("similarity_weight", "similarity_bias"):
        grads[k] = grads[k] * 0.01
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    scale = torch.clamp(3.0 / (norm + 1e-6), max=1.0)
    grads = {k: g * scale for k, g in grads.items()}
    opt.step(W, grads)
    return float(loss.detach()), grads


class Adam:
    """Adam (β 0.9 / 0.999, ε 1e-8, bias-corrected), state per leaf name."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m: Dict[str, Tensor] = {}
        self.v: Dict[str, Tensor] = {}

    @torch.no_grad()
    def step(self, W: Weights, grads: Dict[str, Tensor]) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
            v = self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            W[k].sub_(self.lr * mh / (vh.sqrt() + self.eps))
