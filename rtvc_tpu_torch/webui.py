"""Browser toolbox (counterpart of ``rtvc_tpu/webui.py``): the reference's
Qt toolbox workflow (browse → embed → synthesize → vocode → autotune, with
the vocoder's real-time factor) as one HTML page with no assets, served by
``serve.py`` beside its API:

  * ``GET  /``                  → the toolbox page (:data:`PAGE`, the JAX
    package's page, equal as a string)
  * ``GET  /api/samples``       → the audio files under ``samples_dir`` and
    the loaded utterances' names
  * ``POST /api/load``          → ``?sample=NAME`` (a file under
    ``samples_dir``) or a WAV body with ``?name=`` (an upload or a browser
    recording) → embeds the utterance, returns its 768-d embedding
  * ``POST /api/synthesize``    → ``?utt=&text=&seed=`` → WAV, with
    ``X-RTF`` and ``X-Mel-Frames``
  * ``POST /api/autotune``      → ``?utt=&text=&n_seeds=&start_seed=`` →
    the best seed's WAV, with ``X-Best-Seed`` and ``X-Similarity``
  * ``GET  /api/mel``           → the last synthesized mel, downsampled
  * ``GET  /api/projection``    → 2-D t-SNE points of the loaded embeddings
  * ``GET  /api/stream``        → ``?utt=&text=`` → the clone as a chunked
    streaming WAV (400 while the native engine is the vocoder: the stream
    runs the port's WaveRNN through K1)

State lives in a :class:`UIState`. Every model section of a route runs on
the server's one model thread (``handler.server.on_models``): the
embedding of ``/api/load``; the synthesis, vocode and ``last_mel`` update
of ``/api/synthesize`` in one call, so that no other request comes between
them; the seed search of ``/api/autotune``; and each step of
``/api/stream``'s generator. Socket reads and writes, decoding and the VAD
stay on the handler threads, so a slow client never holds the model
thread. The vocoder's seed counter moves as the JAX routes move it: one
``set_seed`` a synthesize, one a seed in autotune, none for a stream. The
TUI (``tui.py``) is the terminal's counterpart.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict
from urllib.parse import parse_qs, urlparse

import numpy as np

AUDIO_SUFFIXES = (".wav", ".mp3", ".flac")


@dataclass
class UIState:
    samples_dir: Path = None  # type: ignore[assignment]
    utterances: Dict[str, dict] = field(default_factory=dict)
    last_mel: np.ndarray = None  # most recent synthesized spectrogram

    def __post_init__(self):
        if self.samples_dir is None:
            self.samples_dir = (
                Path(__file__).resolve().parents[1] / "samples"
            )

    def sample_files(self, max_entries: int = 50):
        """Audio files under ``samples_dir`` (recursive, sorted, at most
        ``max_entries``)."""
        root = Path(self.samples_dir)
        if not root.is_dir():
            return []
        out = []
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() in AUDIO_SUFFIXES:
                out.append(p)
                if len(out) >= max_entries:
                    break
        return out


def _load_utterance(state: UIState, name: str, wav: np.ndarray):
    """Embed a preprocessed wav and register it (on the model thread)."""
    from rtvc_tpu_torch.config import sp
    from rtvc_tpu_torch.inference import encoder

    embed = encoder.embed_utterance(wav)
    state.utterances[name] = {"wav": wav, "embed": embed}
    return {
        "name": name,
        "seconds": round(len(wav) / sp.sample_rate, 2),
        "embed": [float(v) for v in embed],
    }


def _synthesize(state: UIState, synth, text: str, embed: np.ndarray, seed: int):
    """Synthesize, keep the mel, vocode at ``seed`` (one model-thread call):
    (mel frames, wav, rtf)."""
    from rtvc_tpu_torch import toolbox as tb

    [mel] = synth.synthesize_spectrograms([text], [embed], seed=seed)
    state.last_mel = np.asarray(mel)
    wav, rtf = tb.vocode_with_rtf(mel, seed=seed)
    return np.shape(mel)[-1], wav, rtf


def _autotune(state: UIState, synth, text: str, embed: np.ndarray, n_seeds: int,
              start: int):
    """The seed search (one model-thread call): (best seed, similarity,
    wav or None)."""
    from rtvc_tpu_torch import toolbox as tb

    best_seed, sim, wav, mel = tb.autotune_search(
        synth, embed, text, n_seeds=n_seeds, start_seed=start, verbose=False)
    if mel is not None:
        state.last_mel = np.asarray(mel)
    return best_seed, sim, wav


def _open_stream(synth, text: str, embed: np.ndarray, stream_kwargs: dict):
    """``stream_clone`` of a loaded utterance, on the installed vocoder
    bundle, its chunks seeded by ``stream_kwargs`` alone (the JAX route's
    default key): a stream does not move the seed counter."""
    from rtvc_tpu_torch.inference.streaming import stream_clone

    return stream_clone(synth, None, text, embed, **stream_kwargs)


def _send_wav(handler, wav: np.ndarray, headers) -> None:
    from rtvc_tpu_torch import serve as _serve
    from rtvc_tpu_torch.config import sp

    body = _serve._wav_bytes(wav, sp.sample_rate)
    handler.send_response(200)
    handler.send_header("Content-Type", "audio/wav")
    handler.send_header("Content-Length", str(len(body)))
    for key, value in headers:
        handler.send_header(key, value)
    handler.end_headers()
    handler.wfile.write(body)


def handle_get(handler, state: UIState, synth=None, stream_kwargs=None) -> bool:
    """Serve the UI's GET routes; False if the path is not one of them.
    ``handler.server`` is a ``serve.ModelServer`` (its ``on_models``);
    ``stream_kwargs`` go to ``/api/stream``'s ``stream_clone``."""
    path = urlparse(handler.path).path
    if path in ("/", "/index.html"):
        body = PAGE.encode()
        handler.send_response(200)
        handler.send_header("Content-Type", "text/html; charset=utf-8")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
        return True
    if path == "/api/samples":
        root = Path(state.samples_dir)
        handler._json({
            "samples": [str(p.relative_to(root))
                        for p in state.sample_files()],
            # list() snapshots at once: /api/load may insert from another
            # connection
            "loaded": sorted(list(state.utterances)),
        })
        return True
    if path == "/api/mel":
        # the last synthesized mel, downsampled for the page's canvas
        mel = state.last_mel
        if mel is None:
            handler._json({"error": "nothing synthesized yet"}, 404)
            return True
        m = np.asarray(mel, np.float32)
        step = max(1, m.shape[1] // 512)
        m = m[:, ::step]
        handler._json({
            "n_mels": int(m.shape[0]), "frames": int(m.shape[1]),
            "lo": float(m.min()), "hi": float(m.max()),
            "mel": [[round(float(v), 3) for v in row] for row in m],
        })
        return True
    if path == "/api/stream":
        # serve.py's POST /stream for a loaded utterance, as a GET: an
        # <audio src> plays the chunked WAV as it comes
        from rtvc_tpu_torch import serve as _serve
        from rtvc_tpu_torch.config import sp
        from rtvc_tpu_torch.inference import vocoder

        q = parse_qs(urlparse(handler.path).query)
        text = (q.get("text") or [""])[0]
        utt = state.utterances.get((q.get("utt") or [""])[0])
        if not text or utt is None or synth is None:
            handler._json({"error": "need ?text= and a loaded ?utt="}, 400)
            return True
        if vocoder._bundle is None:
            handler._json({"error": "streaming needs the port's WaveRNN vocoder "
                                    "(K1) loaded; the native engine does not stream"}, 400)
            return True
        on_models = handler.server.on_models
        gen = on_models(_open_stream, synth, text, utt["embed"], dict(stream_kwargs or {}))
        _serve.stream_chunked_wav(handler, gen, on_models, sp.sample_rate)
        return True
    if path == "/api/projection":
        # 2-D projection of the loaded embeddings (the reference's UMAP
        # plot) through the port's t-SNE
        names = sorted(list(state.utterances))  # a snapshot at once
        if len(names) < 2:
            handler._json({"points": [],
                           "note": "load 2+ utterances to project"})
            return True
        from rtvc_tpu_torch.utils.projection import project_2d

        pts = project_2d(np.stack(
            [state.utterances[n]["embed"] for n in names]))
        handler._json({"points": [
            {"name": n, "x": float(x), "y": float(y)}
            for n, (x, y) in zip(names, pts)
        ]})
        return True
    return False


def handle_post(handler, state: UIState, synth) -> bool:
    """Serve the UI's POST routes; False if the path is not one of them.
    Model work goes to ``handler.server.on_models``; socket reads and
    writes stay here."""
    from rtvc_tpu_torch import serve as _serve
    from rtvc_tpu_torch.inference import encoder

    url = urlparse(handler.path)
    q = parse_qs(url.query)
    on_models = handler.server.on_models

    def arg(key, default=""):
        return (q.get(key) or [default])[0]

    if url.path == "/api/load":
        # decoding and the VAD are host work and error answers are socket
        # writes: both stay here; only the embedding and the insert go to
        # the model thread
        sample = arg("sample")
        body = handler._read_body()
        if sample:
            root = Path(state.samples_dir).resolve()
            fpath = (root / sample).resolve()
            # stay inside samples_dir (no ../ traversal)
            if not (fpath.is_relative_to(root) and fpath.is_file()):
                handler._json({"error": f"no sample {sample!r}"}, 404)
                return True
            name = fpath.stem
            wav = encoder.preprocess_wav(fpath)
        else:
            if not body:
                handler._json(
                    {"error": "need ?sample= or a WAV body"}, 400)
                return True
            name = arg("name", "uploaded")
            raw, in_sr = _serve._parse_wav(body)
            wav = encoder.preprocess_wav(raw, source_sr=in_sr)
        if len(wav) == 0:
            handler._json({"error": "no speech after VAD trim"}, 400)
            return True
        handler._json(on_models(_load_utterance, state, name, wav))
        return True

    if url.path == "/api/synthesize":
        handler._read_body()  # drain: keep-alive framing stays in sync
        text, utt_name = arg("text"), arg("utt")
        seed = int(arg("seed", "0"))
        utt = state.utterances.get(utt_name)
        if not text or utt is None:
            handler._json({"error": "need ?text= and a loaded ?utt="}, 400)
            return True
        frames, wav, rtf = on_models(_synthesize, state, synth, text, utt["embed"], seed)
        _send_wav(handler, wav, (("X-RTF", f"{rtf:.2f}"), ("X-Mel-Frames", str(frames))))
        return True

    if url.path == "/api/autotune":
        handler._read_body()  # drain: keep-alive framing stays in sync
        text, utt_name = arg("text"), arg("utt")
        n_seeds = max(1, min(int(arg("n_seeds", "5")), 50))
        start = int(arg("start_seed", "0"))
        utt = state.utterances.get(utt_name)
        if not text or utt is None:
            handler._json({"error": "need ?text= and a loaded ?utt="}, 400)
            return True
        best_seed, sim, wav = on_models(_autotune, state, synth, text, utt["embed"], n_seeds,
                                        start)
        if wav is None:
            handler._json({"error": "autotune produced no voiced audio"},
                          500)
            return True
        _send_wav(handler, wav, (("X-Best-Seed", str(best_seed)), ("X-Similarity", f"{sim:.4f}")))
        return True

    return False


PAGE = """<!doctype html>
<meta charset="utf-8">
<title>rtvc_tpu toolbox</title>
<style>
 body{font:14px/1.45 system-ui,sans-serif;margin:0;background:#14161a;color:#e8e8e8}
 header{padding:10px 18px;background:#1d2026;border-bottom:1px solid #2c313a}
 header b{color:#7ec8ff}
 main{display:grid;grid-template-columns:290px 1fr;gap:16px;padding:16px}
 section{background:#1d2026;border:1px solid #2c313a;border-radius:8px;padding:14px}
 h2{font-size:13px;text-transform:uppercase;letter-spacing:.08em;color:#9aa3b0;margin:0 0 10px}
 button{background:#2d5f8a;color:#fff;border:0;border-radius:5px;padding:6px 12px;cursor:pointer;margin:2px 0}
 button:hover{background:#3874a8} button:disabled{opacity:.45;cursor:wait}
 select,input,textarea{background:#14161a;color:#e8e8e8;border:1px solid #3a404c;border-radius:5px;padding:5px;width:100%;box-sizing:border-box}
 textarea{height:70px;resize:vertical}
 canvas{image-rendering:pixelated;border:1px solid #2c313a;border-radius:4px}
 .row{display:flex;gap:8px;align-items:center;margin:6px 0}
 .row label{flex:0 0 auto;color:#9aa3b0}
 #status{color:#ffd479;min-height:1.3em;white-space:pre-wrap}
 #rtf{color:#8ef0a1}
 audio{width:100%;margin-top:8px}
 .utt{padding:3px 6px;border-radius:4px;cursor:pointer}
 .utt.sel{background:#2d5f8a}
</style>
<header><b>rtvc_tpu</b> toolbox — browse · embed · synthesize · vocode · autotune</header>
<main>
 <section>
  <h2>Utterances</h2>
  <div class="row"><select id="samples"></select><button onclick="loadSample()">Load</button></div>
  <div class="row"><input type="file" id="file" accept="audio/wav"><button onclick="uploadFile()">Upload</button></div>
  <div class="row"><button id="rec" onclick="toggleRec()">● Record</button>
   <button onclick="projection()">Project</button></div>
  <div id="utts"></div>
  <canvas id="proj" width="260" height="200" style="width:260px;height:200px;margin-top:8px"></canvas>
 </section>
 <section>
  <h2>Clone</h2>
  <div class="row"><canvas id="heat" width="32" height="24" style="width:192px;height:144px"></canvas>
   <div><div id="uttinfo">no utterance loaded</div><div id="rtf"></div></div></div>
  <textarea id="text">Welcome to the toolbox! Type a sentence here, then click synthesize.</textarea>
  <div class="row"><label>seed</label><input id="seed" type="number" value="0" style="width:90px">
   <button id="synth" onclick="synthesize()">Synthesize + vocode</button>
   <button onclick="streamPlay()">Stream</button>
   <label>seeds</label><input id="nseeds" type="number" value="5" style="width:70px">
   <button id="tune" onclick="autotune()">Autotune</button></div>
  <div id="status"></div>
  <audio id="player" controls></audio>
  <canvas id="mel" width="512" height="80" style="width:100%;height:120px;margin-top:8px"></canvas>
 </section>
</main>
<script>
let current=null, recorder=null;
const $=id=>document.getElementById(id);
function status(m){$('status').textContent=m}
async function refresh(){
  const r=await (await fetch('/api/samples')).json();
  // DOM nodes, not innerHTML: names come from the filesystem / uploads
  // and must never be interpreted as markup
  const sel=$('samples'); sel.innerHTML='';
  r.samples.forEach(s=>{const o=document.createElement('option');
    o.textContent=s; sel.add(o)});
  const box=$('utts'); box.innerHTML='';
  r.loaded.forEach(n=>{const d=document.createElement('div');
    d.className='utt'+(n===current?' sel':''); d.textContent=n;
    d.onclick=()=>select(n); box.appendChild(d)});
}
function drawHeat(embed){
  const c=$('heat').getContext('2d'), img=c.createImageData(32,24);
  const mx=Math.max(...embed.map(Math.abs))||1;
  embed.forEach((v,i)=>{const t=(v/mx+1)/2, o=i*4;  // blue→white→orange
    img.data[o]=255*t; img.data[o+1]=120+80*(1-Math.abs(2*t-1)); img.data[o+2]=255*(1-t); img.data[o+3]=255;});
  c.putImageData(img,0,0);
}
function registered(r){current=r.name;
  $('uttinfo').textContent=`${r.name} — ${r.seconds}s, 768-d embedding`;
  drawHeat(r.embed); refresh();}
async function api(url,opts,label){
  status(label+'…'); document.querySelectorAll('button').forEach(b=>b.disabled=true);
  try{const r=await fetch(url,opts);
    if(!r.ok){status('error: '+(await r.text()).slice(0,200)); return null}
    return r;
  }finally{document.querySelectorAll('button').forEach(b=>b.disabled=false)}
}
async function loadSample(){
  const r=await api('/api/load?sample='+encodeURIComponent($('samples').value),{method:'POST'},'embedding');
  if(r){registered(await r.json()); status('loaded')}
}
async function uploadFile(){
  const f=$('file').files[0]; if(!f)return status('pick a wav first');
  const r=await api('/api/load?name='+encodeURIComponent(f.name.replace(/\\.wav$/i,'')),
    {method:'POST',body:await f.arrayBuffer()},'embedding');
  if(r){registered(await r.json()); status('loaded')}
}
async function select(n){current=n; status('selected '+n); refresh()}
async function playFrom(r,extra){
  const rtf=r.headers.get('X-RTF');
  $('player').src=URL.createObjectURL(await r.blob()); $('player').play();
  if(rtf)$('rtf').textContent=`vocoder ${rtf}x real-time`;
  status(extra||'done');
}
async function synthesize(){
  if(!current)return status('load an utterance first');
  const u=`/api/synthesize?utt=${encodeURIComponent(current)}&seed=${$('seed').value}`+
          `&text=${encodeURIComponent($('text').value)}`;
  const r=await api(u,{method:'POST'},'synthesizing');
  if(r){await playFrom(r); drawMel()}
}
function streamPlay(){
  if(!current)return status('load an utterance first');
  $('player').src=`/api/stream?utt=${encodeURIComponent(current)}`+
                  `&text=${encodeURIComponent($('text').value)}`;
  $('player').play(); status('streaming (first audio at the TTFA budget)');
}
async function drawMel(){
  const r=await fetch('/api/mel'); if(!r.ok)return;
  const m=await r.json(), c=$('mel'); c.width=m.frames; c.height=m.n_mels;
  const ctx=c.getContext('2d'), img=ctx.createImageData(m.frames,m.n_mels);
  const span=(m.hi-m.lo)||1;
  for(let y=0;y<m.n_mels;y++)for(let x=0;x<m.frames;x++){
    const t=(m.mel[y][x]-m.lo)/span, o=((m.n_mels-1-y)*m.frames+x)*4;
    img.data[o]=255*Math.min(1,2*t); img.data[o+1]=255*t*t;
    img.data[o+2]=90+120*(1-t); img.data[o+3]=255;}
  ctx.putImageData(img,0,0);
}
async function projection(){
  const r=await (await fetch('/api/projection')).json();
  const c=$('proj'), ctx=c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  if(!r.points.length)return status(r.note||'nothing to project');
  const xs=r.points.map(p=>p.x), ys=r.points.map(p=>p.y);
  const sx=(Math.max(...xs)-Math.min(...xs))||1, sy=(Math.max(...ys)-Math.min(...ys))||1;
  const nx=v=>14+(v-Math.min(...xs))/sx*(c.width-90);
  const ny=v=>12+(v-Math.min(...ys))/sy*(c.height-24);
  ctx.font='10px sans-serif';
  r.points.forEach((p,i)=>{ctx.fillStyle=`hsl(${i*67%360} 70% 62%)`;
    ctx.beginPath();ctx.arc(nx(p.x),ny(p.y),4,0,7);ctx.fill();
    ctx.fillText(p.name,nx(p.x)+6,ny(p.y)+3);});
  status('projection of '+r.points.length+' utterances');
}
async function autotune(){
  if(!current)return status('load an utterance first');
  const u=`/api/autotune?utt=${encodeURIComponent(current)}&n_seeds=${$('nseeds').value}`+
          `&text=${encodeURIComponent($('text').value)}`;
  const r=await api(u,{method:'POST'},'autotuning (n seeds, be patient)');
  if(r)await playFrom(r,`best seed ${r.headers.get('X-Best-Seed')} — similarity ${r.headers.get('X-Similarity')}`);
}
// microphone record → 16-bit WAV in JS (MediaRecorder would give webm,
// which the server deliberately does not decode)
async function toggleRec(){
  if(recorder){recorder.stop(); return}
  const stream=await navigator.mediaDevices.getUserMedia({audio:true});
  const ctx=new AudioContext(), src=ctx.createMediaStreamSource(stream);
  const proc=ctx.createScriptProcessor(4096,1,1), bufs=[];
  proc.onaudioprocess=e=>bufs.push(new Float32Array(e.inputBuffer.getChannelData(0)));
  src.connect(proc); proc.connect(ctx.destination);
  $('rec').textContent='■ Stop'; status('recording…');
  recorder={stop:async()=>{
    proc.disconnect(); src.disconnect(); stream.getTracks().forEach(t=>t.stop());
    const n=bufs.reduce((a,b)=>a+b.length,0), pcm=new Int16Array(n); let o=0;
    for(const b of bufs)for(const v of b)pcm[o++]=Math.max(-1,Math.min(1,v))*32767;
    const hdr=new DataView(new ArrayBuffer(44));
    const W=(p,s)=>[...s].forEach((c,i)=>hdr.setUint8(p+i,c.charCodeAt(0)));
    W(0,'RIFF');hdr.setUint32(4,36+n*2,true);W(8,'WAVEfmt ');hdr.setUint32(16,16,true);
    hdr.setUint16(20,1,true);hdr.setUint16(22,1,true);hdr.setUint32(24,ctx.sampleRate,true);
    hdr.setUint32(28,ctx.sampleRate*2,true);hdr.setUint16(32,2,true);hdr.setUint16(34,16,true);
    W(36,'data');hdr.setUint32(40,n*2,true);
    const wav=new Blob([hdr,pcm],{type:'audio/wav'});
    recorder=null; $('rec').textContent='● Record';
    const r=await api('/api/load?name=recording',{method:'POST',body:wav},'embedding');
    if(r){registered(await r.json()); status('recorded + embedded')}
  }};
}
refresh(); fetch('/health').then(r=>r.json()).then(h=>
  status(`server ok — platform ${h.platform}, synthesizer ${h.synthesizer}, vocoder ${h.vocoder}`));
</script>
"""
