"""The toolbox as a library surface (counterpart of ``rtvc_tpu/toolbox.py``).

The reference's Qt toolbox browses datasets, loads and embeds utterances
(heatmap and 2-D projection), draws the mel, synthesizes and vocodes with a
backend toggle (the port's WaveRNN through K1, or the native engine), shows
the vocoder's real-time factor, and runs the seed **autotune**: the
generation seed whose audio embeds closest to the reference voice. Here the
same capabilities are composable functions and a headless
:class:`Toolbox`, under three front ends: ``python -m
rtvc_tpu_torch.demo_toolbox`` (subcommands), the curses TUI (``tui.py``)
and the browser page (``webui.py``, served by ``serve.py``). Plots are PNGs
(matplotlib is optional: a plotting call raises ImportError where it does
not import), audio is WAV; the projection is the port's t-SNE
(``utils/projection.py``). On the card, an embedding is K3 three times,
a synthesis K2 and K4, a vocode K1.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.inference import encoder as encoder_inf
from rtvc_tpu_torch.inference import synthesizer as synthesizer_inf
from rtvc_tpu_torch.inference import vocoder as vocoder_inf
from rtvc_tpu_torch.utils.io import save_wav

VOC_BACKEND_JAX = vocoder_inf.VOC_TYPE_PYTORCH  # the reference's toggle: "pytorch"
VOC_BACKEND_NATIVE = vocoder_inf.VOC_TYPE_CPP  # "libwavernn"


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend; ImportError naming
    matplotlib where it does not import."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the toolbox's plots need matplotlib, which does not import "
                          "here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def vocode_with_rtf(spec: np.ndarray,
                    seed: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Mel → (waveform, real-time factor) through the installed vocoder,
    after ``set_seed(seed)`` when a seed is given. Shared by the Toolbox,
    the TUI and the web UI."""
    if seed is not None:
        vocoder_inf.set_seed(seed)
    t0 = time.perf_counter()
    wav = vocoder_inf.infer_waveform(spec)
    dt = time.perf_counter() - t0
    rtf = (len(wav) / sp.sample_rate) / max(dt, 1e-9)
    return wav, rtf


def autotune_search(synth, embed: np.ndarray, text: str, n_seeds: int = 10,
                    start_seed: int = 0, verbose: bool = True):
    """For each seed in ``[start_seed, start_seed + n_seeds)``: synthesize
    and vocode at that seed, embed the result (padded with a second of
    silence) and score its dot product with ``embed``. Returns
    (best_seed, best_similarity, best_wav, best_mel); best_wav is None when
    no seed gave voiced audio."""
    best = (-1, -np.inf, None, None)
    for seed in range(start_seed, start_seed + n_seeds):
        [spec] = synth.synthesize_spectrograms([text], [embed], seed=seed)
        wav, _ = vocode_with_rtf(spec, seed=seed)
        processed = encoder_inf.preprocess_wav(
            np.pad(np.asarray(wav, np.float32), (0, sp.sample_rate))
        )
        if len(processed) == 0:
            continue
        gen_embed = encoder_inf.embed_utterance(processed)
        sim = float(np.dot(gen_embed, embed))
        if verbose:
            print("  seed %d → voice similarity %.4f" % (seed, sim))
        if sim > best[1]:
            best = (seed, sim, wav, spec)
    return best


@dataclass
class Utterance:
    name: str
    speaker_name: str
    wav: np.ndarray
    embed: np.ndarray
    partial_embeds: Optional[np.ndarray] = None


@dataclass
class Toolbox:
    """Headless toolbox session state."""

    datasets_root: Optional[Path] = None
    out_dir: Path = Path("toolbox_out")
    utterances: List[Utterance] = field(default_factory=list)
    synthesizer: Optional[synthesizer_inf.Synthesizer] = None

    # -- dataset browsing ---------------------------------------------------
    def browse_datasets(self, max_entries: int = 20) -> List[Path]:
        if self.datasets_root is None:
            return []
        wavs = sorted(Path(self.datasets_root).glob("**/*.wav"))
        return wavs[:max_entries]

    def record(self, duration_s: float = 5.0) -> np.ndarray:
        """Microphone recording, as the reference toolbox offers. No audio
        input device is reachable from here: raises with the workaround."""
        raise RuntimeError(
            "No audio input device is available in this environment. Record "
            "a wav elsewhere and pass it to load_utterance()/clone instead."
        )

    # -- embedding ------------------------------------------------------------
    def load_utterance(self, fpath: Path, speaker_name: Optional[str] = None) -> Utterance:
        wav = encoder_inf.preprocess_wav(fpath)
        embed, partials, _ = encoder_inf.embed_utterance(wav, return_partials=True)
        utt = Utterance(
            name=Path(fpath).stem,
            speaker_name=speaker_name or Path(fpath).parent.name,
            wav=wav,
            embed=embed,
            partial_embeds=partials,
        )
        self.utterances.append(utt)
        return utt

    def save_embedding_heatmap(self, utt: Utterance, out: Optional[Path] = None) -> Path:
        plt = _pyplot()
        out = out or Path(self.out_dir) / f"embed_{utt.name}.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        fig, ax = plt.subplots(figsize=(4, 4))
        encoder_inf.plot_embedding_as_heatmap(utt.embed, ax=ax, title=utt.name)
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out

    def save_projection(self, out: Optional[Path] = None) -> Optional[Path]:
        """2-D projection of all loaded utterance embeddings, coloured by
        speaker (the reference's UMAP plot, drawn with the port's t-SNE,
        PCA for tiny n); None with fewer than two utterances."""
        if len(self.utterances) < 2:
            return None
        plt = _pyplot()
        from rtvc_tpu_torch.utils.projection import project_2d

        embeds = np.stack([u.embed for u in self.utterances])
        pts = project_2d(embeds)
        speakers = sorted({u.speaker_name for u in self.utterances})
        colors = {s: i for i, s in enumerate(speakers)}
        out = out or Path(self.out_dir) / "projection.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        fig, ax = plt.subplots(figsize=(5, 5))
        for u, (x, y) in zip(self.utterances, pts):
            ax.scatter(x, y, c=[plt.cm.tab10(colors[u.speaker_name] % 10)])
            ax.annotate(u.name, (x, y), fontsize=6)
        ax.set_title("Utterance embeddings (t-SNE projection)")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out

    # -- synthesis / vocoding ---------------------------------------------------
    def synthesize(self, text: str, utt: Utterance, seed: int = 0) -> np.ndarray:
        assert self.synthesizer is not None, "load a synthesizer first"
        specs = self.synthesizer.synthesize_spectrograms(
            [text], [utt.embed], seed=seed
        )
        return specs[0]

    def vocode(
        self, spec: np.ndarray, seed: Optional[int] = None,
        backend: str = VOC_BACKEND_JAX,
    ) -> Tuple[np.ndarray, float]:
        """Mel → (waveform, real-time factor) through the installed
        vocoder, whichever backend ``vocoder.load_model`` installed;
        ``backend`` is the TUI's toggle, which the JAX package's Toolbox
        also takes and does not act on."""
        return vocode_with_rtf(spec, seed=seed)

    def save_audio(self, wav: np.ndarray, name: str) -> Path:
        out = Path(self.out_dir) / f"{name}.wav"
        out.parent.mkdir(parents=True, exist_ok=True)
        save_wav(wav, out, sp.sample_rate)
        return out

    # -- autotune -----------------------------------------------------------------
    def autotune(
        self,
        text: str,
        utt: Utterance,
        n_seeds: int = 10,
        start_seed: int = 0,
    ) -> Tuple[int, float, np.ndarray]:
        """Search generation seeds for the one whose cloned audio embeds
        closest to the reference voice. Returns (best_seed, best_similarity,
        best_wav)."""
        assert self.synthesizer is not None, "load a synthesizer first"
        seed, sim, wav, _ = autotune_search(
            self.synthesizer, utt.embed, text, n_seeds=n_seeds,
            start_seed=start_seed,
        )
        return seed, sim, wav
