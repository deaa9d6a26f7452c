"""Duration extraction from Tacotron attention + attention quality scores.

Capability parity with the reference (ref: synthesizer/utils/
duration_extractor.py:11-130, synthesizer/preprocess.py:474-501), redesigned:
the reference builds an O((T·C)²)-sized sparse graph and runs Dijkstra; the
shortest monotonic path on a right/down/diag DAG is a plain O(T·C) dynamic
program, so that is what we do — identical path, ~1000× less work.

This package's own copy of ``rtvc_tpu/data/duration_extractor.py``: the port
imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from rtvc_tpu_torch.text.symbols import silent_phonemes_indices


def shortest_monotonic_path(cost: np.ndarray) -> np.ndarray:
    """DP shortest path from (0,0) to (T-1,C-1) with moves right/down/diag;
    entering cell (i,j) costs ``cost[i,j]``. Returns the list of (i, j) cells
    on the path."""
    T, C = cost.shape
    INF = np.inf
    dist = np.full((T, C), INF)
    move = np.zeros((T, C), dtype=np.int8)  # 0=start 1=right 2=down 3=diag
    dist[0, 0] = cost[0, 0]
    for i in range(T):
        row = dist[i]
        if i > 0:
            prev = dist[i - 1]
            # down and diag candidates computed vectorized
            down = prev + cost[i]
            diag = np.full(C, INF)
            diag[1:] = prev[:-1] + cost[i, 1:]
            better_diag = diag < down
            cand = np.where(better_diag, diag, down)
            cand_move = np.where(better_diag, 3, 2).astype(np.int8)
            take = cand < row
            row[take] = cand[take]
            move[i][take] = cand_move[take]
        # right moves must be sequential within the row
        for j in range(1, C):
            right = row[j - 1] + cost[i, j]
            if right < row[j]:
                row[j] = right
                move[i, j] = 1
    # backtrack
    path = []
    i, j = T - 1, C - 1
    while True:
        path.append((i, j))
        m = move[i, j]
        if i == 0 and j == 0:
            break
        if m == 1:
            j -= 1
        elif m == 2:
            i -= 1
        elif m == 3:
            i -= 1
            j -= 1
        else:  # unreachable defensive fallback
            break
    path.reverse()
    return np.asarray(path)


class DurationExtractor:
    """Attention matrix → per-token durations (ref semantics:
    duration_extractor.py:23-85 — silence-probability shift for unvoiced
    regions, monotonic-path assignment, attention-score average)."""

    def __init__(self, silence_threshold: float, silence_prob_shift: float):
        self.silence_threshold = silence_threshold
        self.silence_prob_shift = silence_prob_shift

    def __call__(
        self, x: np.ndarray, mel: np.ndarray, att: np.ndarray
    ) -> Tuple[np.ndarray, float]:
        """x: (T_text,) token ids; mel: (n_mels, T_mel); att:
        (T_mel, T_text). Returns (durations (T_text,), attention score)."""
        x = np.asarray(x)
        mel = np.asarray(mel)
        att = np.array(att, dtype=np.float64, copy=True)
        mel_len = mel.shape[-1]
        att = att[:mel_len]

        # Nudge attention toward silent tokens inside unvoiced mel regions
        # (ref: duration_extractor.py:40-50)
        sil_mask = mel.mean(axis=0) < self.silence_threshold
        sil_tok = np.isin(x, np.asarray(silent_phonemes_indices))
        shift = sil_tok.astype(np.float64) * self.silence_prob_shift * 2 - self.silence_prob_shift
        att[sil_mask] += shift[None, :]
        att = np.clip(att, 0.0, 1.0)

        path_probs = 1.0 - att
        path = shortest_monotonic_path(path_probs)

        # last token index visited per mel frame
        mel_text = {}
        att_scores = []
        for i, j in path:
            mel_text[int(i)] = int(j)
            if not sil_mask[int(i)]:
                att_scores.append(float(att[int(i), int(j)]))

        durations = np.zeros(x.shape[0], dtype=np.float32)
        for j in mel_text.values():
            durations[j] += 1

        att_score = float(np.mean(att_scores)) if att_scores else 0.0
        return durations, att_score


def attention_scores(
    att: np.ndarray, mel_lens: np.ndarray, r: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """(alignment score, sharpness score) per batch element
    (ref: get_attention_score, synthesizer/preprocess.py:474-501).

    att: (B, T_mel, T_text); mel_lens: (B,).
    """
    att = np.asarray(att)
    b, t_max, _ = att.shape
    mel_lens = np.asarray(mel_lens) // r
    mask = (np.arange(t_max)[None, :] < mel_lens[:, None]).astype(np.float64)

    max_loc = np.argmax(att, axis=2)
    max_loc_diff = np.abs(max_loc[:, 1:] - max_loc[:, :-1])
    loc_score = ((max_loc_diff >= 0) & (max_loc_diff <= r)).astype(np.float64)
    loc_score = (loc_score * mask[:, 1:]).sum(axis=1) / np.maximum(mel_lens - 1, 1)

    sharp = att.max(axis=2)
    sharp_score = (sharp * mask).mean(axis=1)
    return loc_score, sharp_score
