"""Project utterance embeddings of a speakers tree into 2-D and save a
scatter plot, one color per speaker (ref demo: scripts/ted_project.py, which
uses resemblyzer + UMAP; here the framework's own speaker encoder embeds and
the projection comes from rtvc_tpu_torch.utils.projection).

Usage: python -m rtvc_tpu_torch.scripts.ted_project <speakers_root>
[-m encoder.pt] [--device cuda]
where <speakers_root>/<speaker>/*.{wav,flac,mp3} holds the utterances.

The port's copy of ``scripts/ted_project.py``: its source with the imports
naming ``rtvc_tpu_torch``, the body cut into :func:`embed_speakers`,
:func:`save_projection` and :func:`main`, and ``--device`` (the card unless
it names another), on which the encoder's LSTMs run through K3. The plot
needs matplotlib: where it does not import, :func:`save_projection` raises
ImportError naming it, after the embeddings and the projection.
"""
import argparse
from pathlib import Path

import numpy as np


def embed_speakers(speakers_root: Path, model=None, max_utterances: int = 10, device=None):
    """Every speaker's first ``max_utterances`` utterances embedded by the
    encoder of checkpoint ``model`` (random weights for None) on ``device``
    → (embeds (N, E), the speaker of each)."""
    from rtvc_tpu_torch.inference import encoder

    if model is not None:
        encoder.load_model(model, device=device)
    else:
        print("No checkpoint given — using a random-init encoder "
              "(clusters reflect spectral similarity only).")
        encoder.init_random_model(device=device)

    embeds, speakers = [], []
    exts = (".wav", ".flac", ".mp3", ".m4a", ".ogg")
    for spk_dir in sorted(d for d in speakers_root.iterdir() if d.is_dir()):
        files = sorted(
            f for f in spk_dir.iterdir() if f.suffix.lower() in exts
        )[: max_utterances]
        for f in files:
            wav = encoder.preprocess_wav(f)
            if len(wav) < 1600:
                continue
            embeds.append(encoder.embed_utterance(wav))
            speakers.append(spk_dir.name)
    if not embeds:
        raise SystemExit("No utterances found.")
    embeds = np.stack(embeds)
    print(f"Embedded {len(embeds)} utterances from "
          f"{len(set(speakers))} speakers.")
    return embeds, speakers


def save_projection(pts: np.ndarray, speakers, out: Path) -> Path:
    """The scatter plot of the 2-D points ``pts``, one color per speaker,
    saved to ``out``."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("ted_project's plot needs matplotlib, which does not import "
                          "here") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    names = sorted(set(speakers))
    cmap = plt.get_cmap("tab20")
    for i, name in enumerate(names):
        sel = [j for j, s in enumerate(speakers) if s == name]
        ax.scatter(pts[sel, 0], pts[sel, 1], s=14, color=cmap(i % 20),
                   label=name)
    ax.set_title("Embedding projections")
    if len(names) <= 20:
        ax.legend(fontsize=6, markerscale=0.7)
    fig.savefig(out, dpi=150, bbox_inches="tight")
    print(f"Saved {out}")
    return out


def main(argv=None):
    """The script: embeddings, their projection, the plot. Returns the
    embeddings, their speakers and the points."""
    parser = argparse.ArgumentParser(
        description="2-D projection of utterance embeddings per speaker.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("speakers_root", type=Path,
                        help="Dir with one subdir of audio files per speaker")
    parser.add_argument("-m", "--model", type=Path, default=None,
                        help="Encoder checkpoint (random-init if omitted)")
    parser.add_argument("-o", "--out", type=Path, default=None,
                        help="Output PNG (default <root>/projections.png)")
    parser.add_argument("--max_utterances", type=int, default=10,
                        help="Per-speaker cap")
    parser.add_argument("--device", default="cuda", help="The torch device to embed on.")
    args = parser.parse_args(argv)

    embeds, speakers = embed_speakers(args.speakers_root, args.model, args.max_utterances,
                                      args.device)

    from rtvc_tpu_torch.utils.projection import project_2d

    pts = project_2d(embeds)

    out = args.out or args.speakers_root / "projections.png"
    save_projection(pts, speakers, out)
    return embeds, speakers, pts


if __name__ == "__main__":
    main()
