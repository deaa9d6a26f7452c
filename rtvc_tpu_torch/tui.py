"""Interactive full-screen terminal toolbox (counterpart of
``rtvc_tpu/tui.py``): the reference's Qt workflow in curses.

Browse a dataset tree (speakers and their utterances, two panes) → load and
embed an utterance (its embedding as a block-glyph heatmap) → type a text
→ synthesize (the mel as a heatmap) → vocode and save → autotune, with a
log pane and one key an action. Every state transition lives in
:class:`TuiState`, which renders to a list of strings and runs without
curses (the tests drive it key by key); :func:`run_curses` is a thin curses
shell around it. Launch with ``python -m rtvc_tpu_torch.demo_toolbox tui``.

Keys: ↑/↓ navigate · Tab switch pane · Enter load+embed · s synthesize
(prompts for text) · v vocode+save · a autotune · b toggle vocoder backend
· p save projection PNG · q quit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

_BLOCKS = " ░▒▓█"


def render_heatmap(arr: np.ndarray, width: int, height: int) -> List[str]:
    """Render a 1-D or 2-D array as unicode block-glyph rows (pure)."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 1:
        side = int(np.ceil(np.sqrt(a.size)))
        pad = np.full(side * side, a.min())
        pad[: a.size] = a
        a = pad.reshape(side, side)
    lo, hi = float(a.min()), float(a.max())
    scale = (a - lo) / max(hi - lo, 1e-12)
    # resample to the target cell grid
    ys = np.linspace(0, a.shape[0] - 1, max(height, 1)).astype(int)
    xs = np.linspace(0, a.shape[1] - 1, max(width, 1)).astype(int)
    grid = scale[np.ix_(ys, xs)]
    idx = np.minimum((grid * len(_BLOCKS)).astype(int), len(_BLOCKS) - 1)
    return ["".join(_BLOCKS[i] for i in row) for row in idx]


_AUDIO_EXTS = (".wav", ".flac", ".mp3", ".m4a", ".ogg")


@dataclass
class TuiState:
    """The toolbox workflow as a key-event state machine (curses-free)."""

    toolbox: object  # rtvc_tpu_torch.toolbox.Toolbox
    datasets_root: Optional[Path] = None
    prompt_fn: Callable[[str], str] = input  # swapped by the curses shell

    speakers: List[Path] = field(default_factory=list)
    utterances: List[Path] = field(default_factory=list)
    spk_idx: int = 0
    utt_idx: int = 0
    pane: int = 0  # 0 = speakers, 1 = utterances
    current = None  # loaded Utterance
    last_spec: Optional[np.ndarray] = None
    last_rtf: Optional[float] = None
    backend: str = "pytorch"
    log: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.refresh_speakers()

    # -- helpers -----------------------------------------------------------
    def say(self, msg: str) -> None:
        self.log.append(msg)
        del self.log[:-8]

    def refresh_speakers(self) -> None:
        root = self.datasets_root
        if root is None or not Path(root).exists():
            self.speakers = []
            return
        self.speakers = sorted(
            d for d in Path(root).glob("**/") if any(
                f.suffix.lower() in _AUDIO_EXTS for f in d.iterdir()
                if f.is_file()
            )
        )[:200]
        self.spk_idx = min(self.spk_idx, max(len(self.speakers) - 1, 0))
        self._refresh_utterances()

    def _refresh_utterances(self) -> None:
        if not self.speakers:
            self.utterances = []
            return
        d = self.speakers[self.spk_idx]
        self.utterances = sorted(
            f for f in d.iterdir()
            if f.is_file() and f.suffix.lower() in _AUDIO_EXTS
        )[:200]
        self.utt_idx = min(self.utt_idx, max(len(self.utterances) - 1, 0))

    # -- key handling ------------------------------------------------------
    def handle_key(self, key: str) -> bool:
        """Process one key; returns False when the session should end."""
        if key == "q":
            return False
        if key == "TAB":
            self.pane = 1 - self.pane
        elif key in ("UP", "DOWN"):
            delta = -1 if key == "UP" else 1
            if self.pane == 0 and self.speakers:
                self.spk_idx = (self.spk_idx + delta) % len(self.speakers)
                self._refresh_utterances()
            elif self.pane == 1 and self.utterances:
                self.utt_idx = (self.utt_idx + delta) % len(self.utterances)
        elif key == "ENTER":
            self._load()
        elif key == "s":
            self._synthesize()
        elif key == "v":
            self._vocode()
        elif key == "a":
            self._autotune()
        elif key == "b":
            self.backend = ("libwavernn" if self.backend == "pytorch"
                            else "pytorch")
            self.say(f"vocoder backend → {self.backend}")
        elif key == "p":
            out = self.toolbox.save_projection()
            self.say(f"projection → {out}" if out
                     else "need ≥2 loaded utterances for a projection")
        return True

    def _load(self) -> None:
        if not self.utterances:
            self.say("no utterance selected")
            return
        f = self.utterances[self.utt_idx]
        try:
            self.current = self.toolbox.load_utterance(
                f, speaker_name=f.parent.name
            )
            self.say(f"loaded + embedded {f.name} "
                     f"({len(self.current.wav) / 16000:.2f}s)")
        except Exception as e:  # surface, don't crash the UI
            self.say(f"load failed: {e}")

    def _synthesize(self) -> None:
        if self.current is None:
            self.say("load an utterance first (Enter)")
            return
        text = self.prompt_fn("Text to synthesize: ").strip()
        if not text:
            return
        try:
            self.last_spec = self.toolbox.synthesize(text, self.current)
            self.say(f"synthesized {self.last_spec.shape[1]} mel frames")
        except Exception as e:
            self.say(f"synthesis failed: {e}")

    def _vocode(self) -> None:
        if self.last_spec is None:
            self.say("synthesize first (s)")
            return
        try:
            wav, rtf = self.toolbox.vocode(self.last_spec,
                                           backend=self.backend)
            self.last_rtf = rtf
            out = self.toolbox.save_audio(wav, "tui_clone")
            self.say(f"vocoded {len(wav) / 16000:.2f}s at {rtf:.1f}× RT → {out}")
        except Exception as e:
            self.say(f"vocode failed: {e}")

    def _autotune(self) -> None:
        if self.current is None:
            self.say("load an utterance first (Enter)")
            return
        text = self.prompt_fn("Autotune text: ").strip()
        if not text:
            return
        try:
            seed, sim, wav = self.toolbox.autotune(text, self.current,
                                                   n_seeds=5)
            out = self.toolbox.save_audio(wav, f"tui_autotune_seed{seed}")
            self.say(f"autotune best seed {seed} (similarity {sim:.4f}) → {out}")
        except Exception as e:
            self.say(f"autotune failed: {e}")

    # -- rendering ---------------------------------------------------------
    def render(self, width: int = 100, height: int = 30) -> List[str]:
        """Draw the whole screen as strings (pure; the curses shell blits)."""
        half = width // 2 - 1
        lines = []
        mark = ["[speakers]", "[utterances]"]
        mark[self.pane] = mark[self.pane].upper()
        lines.append(f"rtvc_tpu toolbox  {mark[0]} {mark[1]}  "
                     f"backend={self.backend}")
        lines.append("─" * width)
        list_h = max(height - 14, 4)
        for i in range(list_h):
            l = r = ""
            si = self.spk_idx - list_h // 2 + i
            ui = self.utt_idx - list_h // 2 + i
            if 0 <= si < len(self.speakers):
                cur = ">" if si == self.spk_idx and self.pane == 0 else " "
                l = f"{cur} {self.speakers[si].name[:half - 2]}"
            if 0 <= ui < len(self.utterances):
                cur = ">" if ui == self.utt_idx and self.pane == 1 else " "
                r = f"{cur} {self.utterances[ui].name[:half - 2]}"
            lines.append(f"{l:<{half}}│{r:<{half}}")
        lines.append("─" * width)
        if self.current is not None:
            lines.append(f"embedded: {self.current.speaker_name}/"
                         f"{self.current.name}")
            lines.extend(render_heatmap(self.current.embed, width, 3))
        if self.last_spec is not None:
            lines.append(f"mel ({self.last_spec.shape[1]} frames)"
                         + (f"  last vocode {self.last_rtf:.1f}× RT"
                            if self.last_rtf else ""))
            lines.extend(render_heatmap(self.last_spec[::-1], width, 4))
        footer = ["─" * width]
        footer.extend(("  " + m)[:width] for m in self.log[-4:])
        footer.append("↑↓ Tab Enter=embed s=synth v=vocode a=autotune "
                      "b=backend p=project q=quit")
        body = lines[: max(height - len(footer), 0)]
        return [l[:width] for l in (body + footer)[:height]]


def run_curses(state: TuiState) -> None:
    """Thin curses shell around :class:`TuiState`."""
    import curses

    def _prompt(stdscr, label: str) -> str:
        curses.echo()
        h, w = stdscr.getmaxyx()
        stdscr.addstr(h - 1, 0, label[: w - 2].ljust(w - 1))
        stdscr.refresh()
        try:
            text = stdscr.getstr(h - 1, len(label)).decode("utf-8",
                                                           "replace")
        finally:
            curses.noecho()
        return text

    def main(stdscr):
        curses.curs_set(0)
        state.prompt_fn = lambda label: _prompt(stdscr, label)
        keymap = {
            curses.KEY_UP: "UP", curses.KEY_DOWN: "DOWN",
            9: "TAB", 10: "ENTER", curses.KEY_ENTER: "ENTER",
        }
        while True:
            h, w = stdscr.getmaxyx()
            stdscr.erase()
            for i, line in enumerate(state.render(w - 1, h - 1)):
                try:
                    stdscr.addstr(i, 0, line)
                except Exception:
                    pass
            stdscr.refresh()
            c = stdscr.getch()
            key = keymap.get(c, chr(c) if 32 <= c < 127 else "")
            if not state.handle_key(key):
                break

    import curses as _c

    _c.wrapper(main)
