"""The toolbox's command line (counterpart of the JAX package's
``demo_toolbox.py``): the reference's Qt toolbox as subcommands.

    python -m rtvc_tpu_torch.demo_toolbox [-d datasets_root] [-o out_dir]
        [-e enc] [-s syn] [-v voc] [--vocoder_backend {pytorch,libwavernn}]
        [--cpu] {browse,embed,project,clone,autotune,tui,web} ...

``browse`` lists a dataset's wavs; ``embed`` saves an utterance's embedding
heatmap; ``project`` the t-SNE projection of several; ``clone`` synthesizes
and vocodes a text in a voice; ``autotune`` searches seeds for the closest
voice; ``tui`` is the curses toolbox (``tui.py``); ``web`` serves the
browser toolbox (``serve.create_server``'s page and ``/api/*`` over
``--datasets_root``'s audio, the repository's ``samples/`` by default).

The checkpoints may be in any format ``train/checkpoints.py:read_model``
reads. ``--vocoder_backend libwavernn`` loads ``-v`` as an RTVCNAT1 file
(``python -m rtvc_tpu_torch.vocoder_convert_model``) into the native
engine instead of the port's WaveRNN. Without an encoder checkpoint the
models are random (``demo_cli.build_models_for_selftest``): a small
Tacotron and runtimeracer, exported for the engine into ``out_dir`` when
``libwavernn`` is asked for. The models run on the card, or on the CPU
with ``--cpu``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rtvc_tpu_torch import toolbox as tb


def _load_models(args, box: tb.Toolbox, need_synthesis: bool = True) -> None:
    """Install the models a command needs: ``embed`` and ``project`` use
    the encoder alone, the others the three."""
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder

    device = "cpu" if args.cpu else None
    if args.enc_model_fpath.exists():
        encoder.load_model(args.enc_model_fpath, device=device)
        if need_synthesis:
            synth = synthesizer.Synthesizer(args.syn_model_fpath, verbose=False, device=device)
            synth.load()
            vocoder.load_model(args.voc_model_fpath, voc_type=args.vocoder_backend,
                               device=device)
            box.synthesizer = synth
        return
    print("No trained models found — using random weights.")
    from rtvc_tpu_torch import demo_cli

    box.synthesizer = demo_cli.build_models_for_selftest(device)
    if args.vocoder_backend == tb.VOC_BACKEND_NATIVE:
        from rtvc_tpu_torch.native.convert import export_wavernn

        bundle = vocoder._bundle
        weights = Path(args.out_dir) / "selftest_vocoder.bin"
        export_wavernn(bundle.model, bundle.dims, weights)
        vocoder.load_model(weights, voc_type=tb.VOC_BACKEND_NATIVE, verbose=False)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-d", "--datasets_root", type=Path, default=None)
    parser.add_argument("-o", "--out_dir", type=Path, default=Path("toolbox_out"))
    parser.add_argument("-e", "--enc_model_fpath", type=Path,
                        default=Path("saved_models/default/encoder.ckpt"))
    parser.add_argument("-s", "--syn_model_fpath", type=Path,
                        default=Path("saved_models/default/synthesizer.ckpt"))
    parser.add_argument("-v", "--voc_model_fpath", type=Path,
                        default=Path("saved_models/default/vocoder.ckpt"))
    parser.add_argument("--vocoder_backend", type=str, default=tb.VOC_BACKEND_JAX,
                        choices=[tb.VOC_BACKEND_JAX, tb.VOC_BACKEND_NATIVE],
                        help="The port's WaveRNN ('pytorch', the reference's name) or the "
                             "native engine ('libwavernn': -v is an RTVCNAT1 file).")
    parser.add_argument("--cpu", action="store_true",
                        help="Run the models on the CPU (the default is the card).")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("browse", help="List dataset audio files.")
    p.add_argument("--max", type=int, default=20)

    p = sub.add_parser("embed", help="Embed an utterance; save heatmap.")
    p.add_argument("wav", type=Path)

    p = sub.add_parser("project", help="t-SNE projection of several utterances.")
    p.add_argument("wavs", type=Path, nargs="+")

    p = sub.add_parser("clone", help="Clone a voice onto a text.")
    p.add_argument("wav", type=Path)
    p.add_argument("text", type=str)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("autotune", help="Seed search for best voice match.")
    p.add_argument("wav", type=Path)
    p.add_argument("text", type=str)
    p.add_argument("--n_seeds", type=int, default=10)

    sub.add_parser("tui", help="Interactive full-screen terminal toolbox (curses).")

    p = sub.add_parser("web", help="Browser toolbox (serve.py's GET / and /api/*).")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    box = tb.Toolbox(datasets_root=args.datasets_root, out_dir=args.out_dir)

    if args.cmd == "browse":
        for f in box.browse_datasets(args.max):
            print(f)
    elif args.cmd == "embed":
        _load_models(args, box, need_synthesis=False)
        utt = box.load_utterance(args.wav)
        out = box.save_embedding_heatmap(utt)
        print("Saved embedding heatmap to %s" % out)
    elif args.cmd == "project":
        _load_models(args, box, need_synthesis=False)
        for w in args.wavs:
            box.load_utterance(w)
        out = box.save_projection()
        print("Saved projection to %s" % out)
    elif args.cmd == "clone":
        _load_models(args, box)
        utt = box.load_utterance(args.wav)
        spec = box.synthesize(args.text, utt, seed=args.seed)
        wav, rtf = box.vocode(spec, seed=args.seed)
        out = box.save_audio(wav, f"clone_{utt.name}")
        print("Saved %s (vocoder RTF %.1fx)" % (out, rtf))
    elif args.cmd == "autotune":
        _load_models(args, box)
        utt = box.load_utterance(args.wav)
        seed, sim, wav = box.autotune(args.text, utt, n_seeds=args.n_seeds)
        if wav is None:
            raise SystemExit("autotune: no seed produced voiced audio")
        out = box.save_audio(wav, f"autotune_{utt.name}_seed{seed}")
        print("Best seed %d (similarity %.4f) → %s" % (seed, sim, out))
    elif args.cmd == "tui":
        _load_models(args, box)
        from rtvc_tpu_torch.tui import TuiState, run_curses

        run_curses(TuiState(toolbox=box, datasets_root=args.datasets_root))
    elif args.cmd == "web":
        _load_models(args, box)
        from rtvc_tpu_torch.inference import vocoder
        from rtvc_tpu_torch.serve import create_server

        server = create_server(args.host, args.port, synth=box.synthesizer,
                               samples_dir=args.datasets_root)
        if vocoder._bundle is not None:  # K1's build and first launches, as serve.main
            server.on_models(vocoder.warmup)
            server.warm_clone()
        print(f"Browser toolbox on http://{args.host}:{server.server_address[1]}/")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()


if __name__ == "__main__":
    main()
