"""2-D embedding projection for visualization (this package's own copy of
``rtvc_tpu/utils/projection.py``, held equal to it in source by
``tests/test_torch_imports.py``): a self-contained exact t-SNE (numpy,
O(n²), fine for the few-hundred-point batches these plots show) with PCA
initialization and a PCA fallback for tiny inputs. It draws the encoder
trainer's projection plots (``train.eval_hooks.make_encoder_projection_hook``),
the role UMAP plays in the reference's dashboards, without the umap package.
"""
from __future__ import annotations

import numpy as np


def _pca(x: np.ndarray, k: int = 2) -> np.ndarray:
    x = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:k].T


def _calibrate_p(dist2: np.ndarray, perplexity: float) -> np.ndarray:
    """Per-point binary search for the Gaussian bandwidth matching the
    target perplexity; returns the symmetrized joint P."""
    n = dist2.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi = 1e-20, 1e20
        beta = 1.0
        d = np.delete(dist2[i], i)
        for _ in range(60):
            p = np.exp(-d * beta)
            s = p.sum()
            if s <= 1e-12:
                h = 0.0
            else:
                p = p / s
                h = -(p * np.log(np.maximum(p, 1e-20))).sum()
            if abs(h - target) < 1e-4:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi >= 1e20 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo <= 1e-20 else (beta + lo) / 2
        row = np.exp(-dist2[i] * beta)
        row[i] = 0.0
        P[i] = row / max(row.sum(), 1e-12)
    P = (P + P.T) / (2 * n)
    return np.maximum(P, 1e-12)


def tsne_2d(
    embeds: np.ndarray,
    perplexity: float = 30.0,
    n_iter: int = 500,
    learning_rate: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """Exact t-SNE → (n, 2). Deterministic for a given seed."""
    x = np.asarray(embeds, dtype=np.float64)
    n = x.shape[0]
    perplexity = min(perplexity, max((n - 1) / 3.0, 1.0))

    # pairwise squared distances
    sq = (x * x).sum(axis=1)
    dist2 = np.maximum(sq[:, None] + sq[None, :] - 2 * x @ x.T, 0.0)
    P = _calibrate_p(dist2, perplexity)

    rng = np.random.default_rng(seed)
    y = _pca(x, 2)
    denom = y.std(axis=0).max()
    y = y / max(denom, 1e-12) * 1e-2
    y += rng.standard_normal(y.shape) * 1e-4

    gains = np.ones_like(y)
    update = np.zeros_like(y)
    exaggeration_until = 100
    Pex = P * 12.0

    for it in range(n_iter):
        Pcur = Pex if it < exaggeration_until else P
        momentum = 0.5 if it < 250 else 0.8

        ysq = (y * y).sum(axis=1)
        num = 1.0 / (1.0 + np.maximum(
            ysq[:, None] + ysq[None, :] - 2 * y @ y.T, 0.0
        ))
        np.fill_diagonal(num, 0.0)
        Q = np.maximum(num / num.sum(), 1e-12)

        PQ = (Pcur - Q) * num
        grad = 4.0 * ((np.diag(PQ.sum(axis=1)) - PQ) @ y)

        same_sign = np.sign(grad) == np.sign(update)
        gains = np.where(same_sign, gains * 0.8, gains + 0.2)
        gains = np.maximum(gains, 0.01)
        update = momentum * update - learning_rate * gains * grad
        y = y + update
        y = y - y.mean(axis=0)
    return y.astype(np.float32)


def project_2d(embeds: np.ndarray, method: str = "tsne", **kwargs) -> np.ndarray:
    """(n, d) embeddings → (n, 2) points. method: 'tsne' | 'pca'.
    Falls back to PCA when n is too small for a meaningful t-SNE."""
    embeds = np.asarray(embeds)
    if method == "pca" or embeds.shape[0] < 8:
        return _pca(embeds.astype(np.float64), 2).astype(np.float32)
    return tsne_2d(embeds, **kwargs)
