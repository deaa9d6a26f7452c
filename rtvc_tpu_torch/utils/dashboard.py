"""Live training dashboard — dependency-free visdom replacement (a copy of
``rtvc_tpu/utils/dashboard.py``, held equal in source after this docstring
by ``tests/test_torch_imports.py``).

The reference serves visdom dashboards during training (loss curves, step
time, params panes; ref: encoder/visualizations.py:361-554,
synthesizer/visualizations.py, vocoder/visualizations.py, Makefile visdom
targets). Here a stdlib ``http.server`` renders the same information live
from the run directory the port's trainers write (``utils/metrics.py``,
``utils/plots.py``):

  * every ``*.tsv`` MetricsLogger file → auto-refreshing SVG line charts
    (one per metric name), with last-value/step/steps-per-sec readouts;
  * every ``*.png`` artifact (attention plots, mel plots, embedding
    projections from the eval hooks) → an image gallery of the most recent
    files.

Run standalone against a training run dir:

    python -m rtvc_tpu_torch.utils.dashboard <run_dir> [--port 8097]

(8097 is visdom's default port.) The page re-polls every few seconds; no
client dependencies, one file, zero pip packages.
"""
from __future__ import annotations

import argparse
import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Tuple

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rtvc_tpu dashboard</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.2em; background: #fafafa; }}
 h1 {{ font-size: 1.2em; }} h2 {{ font-size: 1em; margin: 1em 0 .3em; }}
 .charts {{ display: flex; flex-wrap: wrap; gap: 14px; }}
 .card {{ background: #fff; border: 1px solid #ddd; border-radius: 6px;
          padding: 8px 10px; }}
 .meta {{ color: #666; font-size: .8em; }}
 img.art {{ max-width: 340px; max-height: 260px; border: 1px solid #ddd;
            border-radius: 4px; margin: 4px; }}
</style></head>
<body>
<h1>rtvc_tpu training dashboard — <code>{run_dir}</code></h1>
<div id="charts" class="charts"></div>
<h2>Latest artifacts</h2>
<div id="artifacts"></div>
<script>
function lineChart(name, pts, latest) {{
  const W = 420, H = 180, P = 34;
  if (pts.length < 2) return '';
  const xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const sx = v => P + (v - x0) / Math.max(x1 - x0, 1e-9) * (W - 2 * P);
  const sy = v => H - P - (v - y0) / Math.max(y1 - y0, 1e-9) * (H - 2 * P);
  const d = pts.map((p, i) => (i ? 'L' : 'M') + sx(p[0]).toFixed(1) + ' ' +
                              sy(p[1]).toFixed(1)).join(' ');
  return `<div class="card"><b>${{name}}</b>
    <span class="meta">last ${{latest[1].toPrecision(5)}} @ step ${{latest[0]}}</span>
    <svg width="${{W}}" height="${{H}}">
      <path d="${{d}}" fill="none" stroke="#2b6cb0" stroke-width="1.5"/>
      <text x="${{P}}" y="${{H - 8}}" class="meta" font-size="10">${{x0}}</text>
      <text x="${{W - P}}" y="${{H - 8}}" font-size="10" text-anchor="end">${{x1}}</text>
      <text x="4" y="${{H - P}}" font-size="10">${{y0.toPrecision(3)}}</text>
      <text x="4" y="${{P}}" font-size="10">${{y1.toPrecision(3)}}</text>
    </svg></div>`;
}}
async function refresh() {{
  const r = await fetch('data.json'); const data = await r.json();
  let h = '';
  for (const [name, pts] of Object.entries(data.metrics))
    h += lineChart(name, pts, pts[pts.length - 1]);
  document.getElementById('charts').innerHTML = h;
  document.getElementById('artifacts').innerHTML = data.artifacts
    .map(a => `<a href="art/${{a}}"><img class="art" src="art/${{a}}" title="${{a}}"></a>`)
    .join('');
}}
refresh(); setInterval(refresh, 4000);
</script></body></html>
"""

_MAX_POINTS = 400


def _read_metrics(run_dir: Path) -> Dict[str, List[Tuple[int, float]]]:
    series: Dict[str, List[Tuple[int, float]]] = {}
    for tsv in sorted(run_dir.glob("**/*.tsv")):
        try:
            lines = tsv.read_text().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            parts = line.split("\t")
            if len(parts) < 3:
                continue
            try:
                step, value = int(parts[0]), float(parts[2])
            except ValueError:
                continue
            series.setdefault(parts[1], []).append((step, value))
    # thin long series so the payload stays small
    for name, pts in series.items():
        if len(pts) > _MAX_POINTS:
            stride = len(pts) // _MAX_POINTS + 1
            series[name] = pts[::stride] + [pts[-1]]
    return series


def _artifacts(run_dir: Path, limit: int = 12) -> List[str]:
    pngs = sorted(
        run_dir.glob("**/*.png"), key=lambda p: p.stat().st_mtime,
        reverse=True,
    )
    return [str(p.relative_to(run_dir)) for p in pngs[:limit]]


def make_handler(run_dir: Path):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path in ("/", "/index.html"):
                page = _PAGE.format(run_dir=html.escape(str(run_dir)))
                self._send(page.encode(), "text/html; charset=utf-8")
            elif self.path == "/data.json":
                body = json.dumps({
                    "metrics": _read_metrics(run_dir),
                    "artifacts": _artifacts(run_dir),
                }).encode()
                self._send(body, "application/json")
            elif self.path.startswith("/art/"):
                rel = self.path[len("/art/"):]
                target = (run_dir / rel).resolve()
                # confine to run_dir AND to .png artifacts — never serve
                # checkpoints/metrics through the image endpoint
                if (
                    run_dir.resolve() not in target.parents
                    or target.suffix != ".png"
                    or not target.is_file()
                ):
                    self.send_error(404)
                    return
                self._send(target.read_bytes(), "image/png")
            else:
                self.send_error(404)

    return Handler


def serve(run_dir, port: int = 8097, background: bool = False,
          host: str = "127.0.0.1"):
    """Serve the dashboard. ``background=True`` returns the server after
    starting it on a daemon thread (for use inside trainers/tests).
    Binds loopback by default (no auth); pass ``host='0.0.0.0'`` to expose."""
    run_dir = Path(run_dir)
    server = ThreadingHTTPServer((host, port), make_handler(run_dir))
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    print(f"Dashboard on http://localhost:{server.server_address[1]} "
          f"(watching {run_dir})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return server


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir", type=Path)
    parser.add_argument("--port", type=int, default=8097)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (0.0.0.0 to expose beyond loopback)")
    args = parser.parse_args()
    serve(args.run_dir, args.port, host=args.host)
