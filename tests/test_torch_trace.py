"""The port's spans and counters (``rtvc_tpu_torch.utils.profiler``) on the
clone and paragraph paths, at tiny widths on the CPU: with no profiler
running a span is one shared null context and ``record_function`` is never
called; under ``torch.profiler`` every span of the path is a
``record_function`` event, nested under its stage's root; the counters
equal hand-worked values and stay out of ``_build.launch_counts``."""
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.config.encoder import EncoderModelParams
from rtvc_tpu_torch.config.synthesizer import ForwardTacotronParams, TacotronParams
from rtvc_tpu_torch.config.vocoder import WaveRNNParams
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.utils import profiler

ENC = EncoderModelParams(model_hidden_size=32, model_embedding_size=768, model_num_layers=2)
SYN = TacotronParams(embed_dims=32, encoder_dims=16, decoder_dims=32, postnet_dims=16,
                     encoder_K=4, lstm_dims=32, postnet_K=4, num_highways=2,
                     max_decoder_steps=20)
FT = ForwardTacotronParams(embed_dims=16, series_embed_dims=8, duration_conv_dims=12,
                           duration_rnn_dims=8, pitch_conv_dims=12, pitch_rnn_dims=8,
                           energy_conv_dims=12, energy_rnn_dims=8, prenet_dims=16, prenet_k=3,
                           prenet_num_highways=2, rnn_dims=16, postnet_dims=12, postnet_k=3,
                           postnet_num_highways=2)
# a short fold window keeps the sample loop's steps few on the CPU
TARGET, OVERLAP = 100, 25
VOC = WaveRNNParams(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=32, res_blocks=2,
                    gen_target=TARGET, gen_overlap=OVERLAP)
FRAMES_A_CHAR = 3  # ForwardTacotron's duration head at weight 0, bias 3
TEXTS = ["Hello there.", "A longer sentence here."]

# each span with the nearest span it nests in (None: a root)
CLONE_SPANS = {
    ("rtvc.encoder.preprocess", None),
    ("rtvc.encoder.embed", None),
    ("rtvc.encoder.mel", "rtvc.encoder.embed"),
    ("rtvc.encoder.lstm", "rtvc.encoder.embed"),
    ("rtvc.synth.synthesize", None),
    ("rtvc.synth.encode", "rtvc.synth.synthesize"),
    ("rtvc.synth.decode", "rtvc.synth.synthesize"),
    ("rtvc.synth.postnet", "rtvc.synth.synthesize"),
    ("rtvc.synth.trim", "rtvc.synth.synthesize"),
}
VOCODER_SPANS = {
    ("rtvc.vocoder.vocode", None),
    ("rtvc.vocoder.upsample", "rtvc.vocoder.vocode"),
    ("rtvc.vocoder.fold", "rtvc.vocoder.vocode"),
    ("rtvc.vocoder.prepare", "rtvc.vocoder.vocode"),
    ("rtvc.vocoder.k1", "rtvc.vocoder.vocode"),
    ("rtvc.vocoder.k1_launch", "rtvc.vocoder.k1"),
    ("rtvc.vocoder.unfold", "rtvc.vocoder.vocode"),
    ("rtvc.vocoder.finish", "rtvc.vocoder.vocode"),
}
PARAGRAPH_SPANS = {
    ("rtvc.encoder.preprocess", None),
    ("rtvc.encoder.embed", None),
    ("rtvc.encoder.mel", "rtvc.encoder.embed"),
    ("rtvc.encoder.lstm", "rtvc.encoder.embed"),
    ("rtvc.synth.synthesize", None),
    ("rtvc.synth.forward", "rtvc.synth.synthesize"),
    ("rtvc.synth.copy", "rtvc.synth.synthesize"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: these models are small, and beside the other test
    workers more OpenMP threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Tiny encoder, Tacotron, ForwardTacotron and runtimeracer vocoder,
    installed in the inference modules for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tenc, "_model", factories.init_encoder_model(1, "cpu", ENC))
        for name in ("_bundle", "_native", "_seed", "_gen_counter"):
            mp.setattr(tvoc, name, getattr(tvoc, name))
        tvoc.load_bundle(factories.init_voc_model("runtimeracer-wavernn", 3, VOC, "cpu"))
        taco = tsyn.Synthesizer(device="cpu")
        taco.load_bundle(factories.init_syn_model("tacotron", 2, SYN, "cpu"), r=2)
        bundle = factories.init_syn_model("forward-tacotron", 4, FT, "cpu")
        with torch.no_grad():
            bundle.model.dur_pred.lin.weight.zero_()
            bundle.model.dur_pred.lin.bias.fill_(float(FRAMES_A_CHAR))
        fwd = tsyn.Synthesizer(device="cpu")
        fwd.load_bundle(bundle)
        t = np.arange(2 * 16000) / 16000
        prompt = (0.2 * np.sin(2 * np.pi * 150 * t)
                  + 0.01 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)
        yield {"taco": taco, "fwd": fwd, "prompt": prompt}


def clone(m):
    """The clone's public calls: prompt → embedding → Tacotron mel → one
    vocode."""
    embed = tenc.embed_utterance(tenc.preprocess_wav(m["prompt"]))
    [mel] = m["taco"].synthesize_spectrograms(TEXTS[:1], [embed], prenet_dropout=False)
    return tvoc.infer_waveform(mel, argmax=True)


def paragraph(m):
    """The paragraph's public calls: prompt → embedding → every sentence in
    one ForwardTacotron call → every mel in one batched vocode."""
    embed = tenc.embed_utterance(tenc.preprocess_wav(m["prompt"]))
    mels = m["fwd"].synthesize_spectrograms(TEXTS, [embed] * len(TEXTS))
    return tvoc.infer_waveforms(mels, argmax=True)


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiler.span("rtvc.a") is profiler.span("rtvc.b")
    with profiler.span("rtvc.a") as inside:
        assert inside is None


def test_paths_never_call_record_function_without_a_profiler(models, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    wave = clone(models)
    waves = paragraph(models)
    assert wave.ndim == 1 and len(waves) == len(TEXTS)


@pytest.mark.parametrize("path,spans", [(clone, CLONE_SPANS | VOCODER_SPANS),
                                        (paragraph, PARAGRAPH_SPANS | VOCODER_SPANS)],
                         ids=["clone", "paragraph"])
def test_spans_are_record_function_events_nested_by_stage(models, path, spans):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path(models)
    found = set()
    for e in prof.events():
        if not e.name.startswith("rtvc."):
            continue
        assert getattr(e, "is_user_annotation", True), e.name  # a record_function range
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("rtvc."):
            parent = parent.cpu_parent
        found.add((e.name, None if parent is None else parent.name))
    assert found == spans


def _mel(frames):
    return np.random.default_rng(frames).uniform(-3.0, 3.0, (80, frames)).astype(np.float32)


# A mel of n frames is padded to a 64-frame bucket, P = ceil(n / 64)·64, and
# upsampled to P·200 samples; the fold window is TARGET + 2·OVERLAP = 150
# steps, with a new fold every 125 samples:
# * 14 frames → 12800 samples; (12800 - 25) // 125 = 102 whole folds and 25
#   samples left over → 103 folds;
# * 96 and 40 frames, one batch at the longer's bucket → 25600 samples a row;
#   (25600 - 25) // 125 = 204, 75 left over → 205 folds a row, 410 in all.
# "Hello there." is 12 characters and EOS, 19 pads in its 32 bucket;
# "A longer sentence here." 23 and EOS, 8 pads: 27 pad characters of 3 frames.
@pytest.mark.parametrize("case,expected", [
    ("vocode one mel", {"rtvc.vocoder.mel_frames": 14,
                        "rtvc.vocoder.k1_samples": 103 * 150}),
    ("vocode a batch", {"rtvc.vocoder.mel_frames": 96 + 40,
                        "rtvc.vocoder.k1_samples": 2 * 205 * 150}),
    ("tacotron", {"rtvc.synth.pad_frames": 0}),
    ("forward tacotron", {"rtvc.synth.pad_frames": 27 * FRAMES_A_CHAR}),
])
def test_counters_count_the_work(models, case, expected):
    launches = dict(_build.launch_counts)
    before = profiler.counts()
    if case == "vocode one mel":
        tvoc.infer_waveform(_mel(14), argmax=True)
    elif case == "vocode a batch":
        tvoc.infer_waveforms([_mel(96), _mel(40)], argmax=True)
    else:
        m = models["taco" if case == "tacotron" else "fwd"]
        embed = np.full(ENC.model_embedding_size, ENC.model_embedding_size ** -0.5, np.float32)
        m.synthesize_spectrograms(TEXTS, [embed] * len(TEXTS))
    after = profiler.counts()
    delta = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert delta == {k: v for k, v in expected.items() if v}
    assert dict(_build.launch_counts) == launches  # the CPU path launches no kernel


def test_counts_is_a_snapshot_and_counting_is_atomic():
    """More threads than cores, switching often: a lost update would show."""
    before = profiler.counts().get("rtvc.test.adds", 0)

    def add():
        for _ in range(2000):
            profiler.count("rtvc.test.adds", 1)

    threads = [threading.Thread(target=add) for _ in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = profiler.counts()
    assert snap["rtvc.test.adds"] - before == 2000 * len(threads)
    snap["rtvc.test.adds"] = -1
    assert profiler.counts()["rtvc.test.adds"] - before == 2000 * len(threads)
    assert not any(k.startswith("rtvc.") for k in _build.launch_counts)
