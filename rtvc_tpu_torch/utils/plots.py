"""Training and evaluation plots (headless matplotlib), the port's own
counterpart of ``rtvc_tpu/utils/plots.py``: attention and mel images at
the synthesizer's evaluation steps, target and generated mels stacked, the
non-autoregressive synthesizers' pitch and energy sweeps, and the vocoder's
target / Griffin-Lim / generated waveforms. ``save_mel_comparison`` is the
JAX package's function with the port's guard for a missing matplotlib.

matplotlib is optional: it is imported on the first plot, and where it does
not import (the GPU machine has none) :func:`available` says so and every
``save_*`` writes nothing and returns None, so that the callers write their
wavs and go on.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _plt():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    does not import."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def available() -> bool:
    """Whether matplotlib imports, so that the ``save_*`` functions plot."""
    return _plt() is not None


def _figure_path(path) -> Path:
    path = Path(path).with_suffix(".png")
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def _save(plt, fig, path: Path) -> Path:
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_attention(attn: np.ndarray, path, title: str = "") -> Optional[Path]:
    """Attention matrix (T_dec, T_text) → PNG."""
    plt = _plt()
    if plt is None:
        return None
    path = _figure_path(path)
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(attn).T, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("decoder step")
    ax.set_ylabel("text position")
    ax.set_title(title)
    return _save(plt, fig, path)


def save_spectrogram(mel: np.ndarray, path, title: str = "") -> Optional[Path]:
    """Mel (n_mels, T) → PNG."""
    plt = _plt()
    if plt is None:
        return None
    path = _figure_path(path)
    fig, ax = plt.subplots(figsize=(8, 3))
    im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return _save(plt, fig, path)


def save_mel_comparison(
    target: np.ndarray, generated: np.ndarray, path: Path, title: str = ""
) -> Path:
    """Target vs generated mel, stacked (GTA eval grids,
    ref: synthesizer/train.py:485-574)."""
    plt = _plt()
    if plt is None:
        return None
    path = Path(path).with_suffix(".png")
    path.parent.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for ax, m, label in zip(axes, (target, generated), ("target", "generated")):
        im = ax.imshow(np.asarray(m), aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_ylabel(label)
    axes[0].set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_series_grid(series: Sequence[np.ndarray], labels: Sequence[str], path,
                     title: str = "") -> Optional[Path]:
    """1-D series in one plot (the pitch and energy sweeps)."""
    plt = _plt()
    if plt is None:
        return None
    path = _figure_path(path)
    fig, ax = plt.subplots(figsize=(8, 3))
    for s, label in zip(series, labels):
        ax.plot(np.asarray(s), label=label, linewidth=1)
    ax.legend(fontsize=7)
    ax.set_title(title)
    return _save(plt, fig, path)


def save_wave_comparison(waves: Sequence[np.ndarray], labels: Sequence[str],
                         path) -> Optional[Path]:
    """Stacked waveforms (the vocoder's target / Griffin-Lim / generated)."""
    plt = _plt()
    if plt is None:
        return None
    path = _figure_path(path)
    fig, axes = plt.subplots(len(waves), 1, figsize=(8, 2 * len(waves)), sharex=True)
    if len(waves) == 1:
        axes = [axes]
    for ax, w, label in zip(axes, waves, labels):
        ax.plot(np.asarray(w), linewidth=0.4)
        ax.set_ylabel(label)
        ax.set_ylim(-1.05, 1.05)
    return _save(plt, fig, path)


def save_scatter(points: np.ndarray, groups: int, path, title: str = "") -> Optional[Path]:
    """2-D points (n, 2) in ``groups`` equal consecutive runs, a colour a
    run (the encoder's speakers) → PNG."""
    plt = _plt()
    if plt is None:
        return None
    path = _figure_path(path)
    per = len(points) // groups
    fig, ax = plt.subplots(figsize=(5, 5))
    for s in range(groups):
        seg = points[s * per:(s + 1) * per]
        ax.scatter(seg[:, 0], seg[:, 1], c=[plt.cm.tab20(s % 20)], s=12)
    ax.set_title(title)
    return _save(plt, fig, path)
