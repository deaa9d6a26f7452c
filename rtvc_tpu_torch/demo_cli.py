"""Interactive voice-cloning CLI (counterpart of the JAX package's
``demo_cli.py``):

    python -m rtvc_tpu_torch.demo_cli [-e enc] [-s syn] [-v voc] [--seed N] [--stream]
                                      [--selftest] [--cpu]

1. A configuration self-test: the encoder on a second of silence, the
   synthesizer on a batch of two texts with a random embedding, the vocoder
   on the two mels joined, with a short fold window; with ``--stream`` also
   a streamed clone of a short text (``inference.streaming.stream_clone``),
   its length held to the stream's invariant.
2. An interactive clone loop: a prompt (wav, or mp3, flac, m4a, ogg, ...
   through ``utils.io.load_wav``) → embedding → text → mel →
   waveform → ``demo_output_NN.wav``; with ``--stream`` the waveform comes
   chunk by chunk from ``stream_clone`` (the first audio after one chunk's
   decode and vocode), and the time to it and each chunk's length are
   printed.

The checkpoints may be in any of the formats of
``train/checkpoints.py:read_model``, the synthesizer of any of the three
types (Tacotron, ForwardTacotron, FastPitch: the file names it). With none
of the three present it runs on random weights (small synthesizer and
vocoder); with only some present it names the missing ones and exits
with 1. The models run on the card, or on
the CPU with ``--cpu``. ``--voc_backend libwavernn`` loads ``-v`` as an
RTVCNAT1 file into the native engine (``native/libwavernn.py``; no
``--stream`` there). Audio is always written to disk.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def build_models_for_selftest(device=None, seed: int = 0):
    """Install random-weight models: the encoder at its default widths, a
    small Tacotron and a small runtimeracer WaveRNN. Returns the
    synthesizer."""
    from rtvc_tpu_torch.config.synthesizer import TacotronParams
    from rtvc_tpu_torch.config.vocoder import WaveRNNParams
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.models import factories

    encoder.init_random_model(seed=seed, device=device)
    syn_cfg = TacotronParams(embed_dims=64, encoder_dims=32, decoder_dims=64, postnet_dims=32,
                             encoder_K=8, lstm_dims=64, postnet_K=4, num_highways=4,
                             max_decoder_steps=400)
    synth = synthesizer.Synthesizer("selftest", verbose=False, device=device)
    synth.load_bundle(factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=seed,
                                               override_hp=syn_cfg, device=device), r=2)
    voc_cfg = WaveRNNParams(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=64,
                            res_blocks=3, gen_target=1000, gen_overlap=200)
    vocoder.load_bundle(factories.init_voc_model(factories.MODEL_TYPE_RUNTIMERACER, seed=seed,
                                                 override_hp=voc_cfg, device=device))
    return synth


def config_test(args):
    """The configuration self-test; returns the synthesizer."""
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.utils import modelutils

    device = factories.resolve_device("cpu" if args.cpu else None)
    print("Running a test of your configuration...\n")
    print("Device: %s" % device)

    missing = modelutils.missing_models(args.enc_model_fpath, args.syn_model_fpath,
                                        args.voc_model_fpath)
    if not missing:
        encoder.load_model(args.enc_model_fpath, device=device)
        synth = synthesizer.Synthesizer(args.syn_model_fpath, device=device)
        synth.load()
        vocoder.load_model(args.voc_model_fpath, voc_type=args.voc_backend, device=device)
    elif len(missing) == 3:
        modelutils.model_files_missing(missing)
        print("Continuing with RANDOM weights for the self-test.\n")
        synth = build_models_for_selftest(device, args.seed or 0)
    else:
        modelutils.model_files_missing(missing)
        sys.exit(1)

    print("Testing the encoder...")
    embed = encoder.embed_utterance(np.zeros(encoder._data.sampling_rate, np.float32))
    assert embed.shape == (768,), embed.shape

    print("Testing the synthesizer...")
    rng = np.random.default_rng(0)
    embed = rng.random(768).astype(np.float32)
    embed /= np.linalg.norm(embed)
    mels = synth.synthesize_spectrograms(["test 1", "test 2"], [embed, embed])
    mel = np.concatenate(mels, axis=1)

    print("Testing the vocoder...")
    wav = vocoder.infer_waveform(mel, target=200, overlap=50)
    assert wav.shape == ((mel.shape[1] - 1) * 200,) and np.isfinite(wav).all(), wav.shape

    if args.stream:
        from rtvc_tpu_torch.inference.streaming import stream_clone

        print("Testing the stream...")
        chunks = list(stream_clone(synth, None, "test 1", embed, seed=args.seed or 0,
                                   voc_target=200, voc_overlap=50))
        wav = np.concatenate([c.wav for c in chunks])
        frames = sum(c.frames for c in chunks)
        assert chunks[-1].final and not any(c.final for c in chunks[:-1])
        assert wav.shape == ((frames - 1) * 200,) and np.isfinite(wav).all(), wav.shape

    print("All test passed! You can now synthesize speech.\n\n")
    return synth


def stream_to_wav(synth, text: str, embed: np.ndarray, seed: int) -> np.ndarray:
    """The streamed clone joined, printing the time to its first audio and
    each chunk's length as they come."""
    import time

    from rtvc_tpu_torch.inference.streaming import stream_clone

    t0 = time.perf_counter()
    pieces = []
    for chunk in stream_clone(synth, None, text, embed, seed=seed):
        if chunk.index == 0:
            print("  first audio after %.0f ms" % (1000 * (chunk.t_emitted - t0)))
        pieces.append(chunk.wav)
        print("  chunk %d: %.2f s" % (chunk.index, len(chunk.wav) / synth.sample_rate))
    return np.concatenate(pieces).astype(np.float64)


def clone_loop(args, synth):
    from rtvc_tpu_torch.inference import encoder, vocoder
    from rtvc_tpu_torch.utils.io import save_wav

    print("Interactive generation loop")
    num_generated = 0
    while True:
        try:
            in_fpath = input("Reference voice: enter an audio filepath of a voice to be "
                             "cloned (wav, mp3, flac, ...):\n")
            in_fpath = Path(in_fpath.replace("\"", "").replace("'", ""))
            preprocessed_wav = encoder.preprocess_wav(in_fpath)
            print("Loaded file successfully")
            embed = encoder.embed_utterance(preprocessed_wav)
            print("Created the embedding")

            text = input("Write a sentence (+-20 words) to be synthesized:\n")
            if args.seed is not None:
                vocoder.set_seed(args.seed)
            if args.stream:
                generated_wav = stream_to_wav(synth, text, embed, args.seed or 0)
            else:
                spec = synth.synthesize_spectrograms([text], [embed])[0]
                print("Created the mel spectrogram")
                print("Synthesizing the waveform:")
                generated_wav = vocoder.infer_waveform(spec)

            # pad a second of silence, then trim it as a prompt is trimmed
            sr = encoder._data.sampling_rate
            generated_wav = np.pad(generated_wav, (0, sr), mode="constant")
            generated_wav = encoder.preprocess_wav(generated_wav)

            filename = "demo_output_%02d.wav" % num_generated
            save_wav(generated_wav, filename, sr)
            num_generated += 1
            print("\nSaved output as %s\n\n" % filename)
        except (EOFError, KeyboardInterrupt):
            print("\nExiting.")
            break
        except Exception as e:
            print("Caught exception: %s" % repr(e))
            print("Restarting\n")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-e", "--enc_model_fpath", type=Path,
                        default=Path("saved_models/default/encoder.ckpt"))
    parser.add_argument("-s", "--syn_model_fpath", type=Path,
                        default=Path("saved_models/default/synthesizer.ckpt"))
    parser.add_argument("-v", "--voc_model_fpath", type=Path,
                        default=Path("saved_models/default/vocoder.ckpt"))
    parser.add_argument("--cpu", action="store_true",
                        help="Run the models on the CPU (the default is the card).")
    parser.add_argument("--voc_backend", type=str, default="pytorch",
                        choices=["pytorch", "libwavernn"],
                        help="Vocoder backend: the port's WaveRNN ('pytorch', the reference's "
                             "name) or the native engine (-v an RTVCNAT1 file).")
    parser.add_argument("--seed", type=int, default=None,
                        help="Optional random number seed for deterministic output.")
    parser.add_argument("--no_sound", action="store_true",
                        help="Accepted for compatibility; audio is always saved to disk.")
    parser.add_argument("--stream", action="store_true",
                        help="Stream the clone in chunks of 48 frames (0.6 s): the first "
                             "audio after one chunk instead of after the whole utterance.")
    parser.add_argument("--selftest", action="store_true",
                        help="Run only the configuration test and exit.")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    synth = config_test(args)
    if not args.selftest:
        clone_loop(args, synth)


if __name__ == "__main__":
    main()
