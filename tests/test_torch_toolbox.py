"""The port's toolbox (``rtvc_tpu_torch/toolbox.py``, ``tui.py`` and
``demo_toolbox.py``) at the narrow widths of ``test_torch_clone.py``, on the
CPU: ``Toolbox.load_utterance`` against the JAX package's Toolbox on the
same weights (the preprocessed wav within 1e-6, the embedding and its
partials within 1e-5, the port's encoder tolerance); ``render_heatmap``'s
rows and the TUI's screens equal to the JAX package's; the sampled paths
(``vocode_with_rtf``, ``autotune_search``, the TUI's workflow) held by
determinism: the same seed gives the same bytes, and autotune's score is
the dot product of the embeddings it names; the PNGs, and an ImportError
naming matplotlib where it does not import; ``python -m
rtvc_tpu_torch.demo_toolbox``'s ``main`` with ``--cpu`` on random weights
(``clone`` with either vocoder backend, ``autotune``, ``browse``, ``embed``,
``project``)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtvc_tpu import toolbox as jtb
from rtvc_tpu import tui as jtui
from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu.inference import encoder as jenc
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch import toolbox as ttb
from rtvc_tpu_torch import tui as ttui
from rtvc_tpu_torch.inference import encoder as tenc
from rtvc_tpu_torch.inference import synthesizer as tsyn
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.utils.io import save_wav_float
from test_torch_clone import ENC, SYN, VOC

TEXT = "Tune this voice."
# a short fold window keeps the CPU sample loop's steps few
VOC_TB = VOC.replace(gen_target=100, gen_overlap=25)
ENC_STATE = (("_model", "_model_cfg", "_data"), ("_bundle", "_native", "_seed", "_gen_counter"))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: beside other test workers more OpenMP threads
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _voice(path: Path, f0: float, seed: int = 0) -> Path:
    sr = 16000
    t = np.arange(2 * sr) / sr
    rng = np.random.default_rng(seed)
    env = (np.sin(2 * np.pi * 2.5 * t) > -0.4).astype(np.float32)
    wav = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.1 * f0 * t)) * env
    path.parent.mkdir(parents=True, exist_ok=True)
    save_wav_float((wav + 0.003 * rng.standard_normal(t.size)).astype(np.float32), path, sr)
    return path


@pytest.fixture(scope="module")
def models():
    """The JAX encoder at ENC's widths from its seed, the port's encoder on
    the same weights, and the port's narrow Tacotron and runtimeracer; the
    inference modules' state restored after the file."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((tenc, ENC_STATE[0]), (tvoc, ENC_STATE[1])):
            for name in names:
                mp.setattr(mod, name, getattr(mod, name))
        for name in ("_model_cfg", "_model", "_params"):
            mp.setattr(jenc, name, getattr(jenc, name))
        mp.setattr(jenc, "_model_cfg", JEncoderModelParams(**ENC.asdict()))
        mp.setattr(jenc, "_model", None)
        jenc.init_random_model(seed=1)
        tenc.load_state(bridge.speaker_encoder_state(jenc._params), device="cpu", model_cfg=ENC)
        synth = tsyn.Synthesizer(verbose=False, device="cpu")
        synth.load_bundle(factories.init_syn_model("tacotron", seed=2, override_hp=SYN,
                                                   device="cpu"), r=2)
        voc = factories.init_voc_model("runtimeracer-wavernn", seed=3, override_hp=VOC_TB,
                                       device="cpu")
        tvoc.load_bundle(voc)
        yield synth, voc


@pytest.fixture
def box(models, tmp_path):
    b = ttb.Toolbox(out_dir=tmp_path / "out")
    b.synthesizer = models[0]
    tvoc.load_bundle(models[1])
    return b


def test_load_utterance_matches_the_jax_toolbox(box, tmp_path):
    path = _voice(tmp_path / "spk_a" / "a.wav", 150.0)
    got = box.load_utterance(path)
    want = jtb.Toolbox(out_dir=tmp_path / "jax").load_utterance(path)
    assert (got.name, got.speaker_name) == (want.name, want.speaker_name) == ("a", "spk_a")
    np.testing.assert_allclose(got.wav, want.wav, atol=1e-6)
    assert got.embed.shape == (768,) and got.partial_embeds.shape == want.partial_embeds.shape
    np.testing.assert_allclose(got.embed, want.embed, atol=1e-5)
    np.testing.assert_allclose(got.partial_embeds, want.partial_embeds, atol=1e-5)
    assert box.utterances == [got]


def test_browse_datasets_lists_as_the_jax_toolbox(tmp_path):
    for spk, n in (("s1", 3), ("s2", 2)):
        for i in range(n):
            _voice(tmp_path / "root" / spk / f"u{i}.wav", 120.0 + 40 * i)
    (tmp_path / "root" / "notes.txt").write_text("not audio")
    for cap in (20, 4):
        got = ttb.Toolbox(datasets_root=tmp_path / "root").browse_datasets(cap)
        assert got == jtb.Toolbox(datasets_root=tmp_path / "root").browse_datasets(cap)
    assert len(got) == 4 and ttb.Toolbox().browse_datasets() == []
    with pytest.raises(RuntimeError, match="No audio input device"):
        ttb.Toolbox().record()


def test_plots_write_pngs_and_name_matplotlib_where_it_is_missing(box, tmp_path, monkeypatch):
    a = box.load_utterance(_voice(tmp_path / "spk_a" / "a.wav", 150.0), "spk_a")
    assert box.save_projection() is None  # one utterance: nothing to project
    box.load_utterance(_voice(tmp_path / "spk_b" / "b.wav", 260.0, seed=1), "spk_b")
    heat, proj = box.save_embedding_heatmap(a), box.save_projection()
    assert heat == box.out_dir / "embed_a.png" and proj == box.out_dir / "projection.png"
    for png in (heat, proj):
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for call in (lambda: box.save_embedding_heatmap(a), box.save_projection,
                 lambda: tenc.plot_embedding_as_heatmap(a.embed)):
        with pytest.raises(ImportError, match="matplotlib"):
            call()


def test_vocode_with_rtf_is_seeded(box):
    mel = np.random.default_rng(5).uniform(-4, 0, (80, 24)).astype(np.float32)
    wav, rtf = ttb.vocode_with_rtf(mel, seed=4)
    again, _ = box.vocode(mel, seed=4, backend=ttb.VOC_BACKEND_JAX)
    later, _ = ttb.vocode_with_rtf(mel)  # the next generation of seed 4
    assert wav.shape == (23 * 200,) and np.isfinite(wav).all() and rtf > 0
    assert np.array_equal(wav, again) and not np.array_equal(wav, later)
    assert (ttb.VOC_BACKEND_JAX, ttb.VOC_BACKEND_NATIVE) == (jtb.VOC_BACKEND_JAX,
                                                            jtb.VOC_BACKEND_NATIVE)


def test_autotune_search_scores_each_seed_by_its_embedding(box, tmp_path):
    """The best seed of 2, its similarity the dot product of the reference
    embedding and the embedding of the audio that seed gives (replayed in
    process); the same search twice gives the same bytes."""
    utt = box.load_utterance(_voice(tmp_path / "spk" / "u.wav", 180.0))
    runs = [ttb.autotune_search(box.synthesizer, utt.embed, TEXT, n_seeds=2, start_seed=4,
                                verbose=False) for _ in range(2)]
    (seed, sim, wav, mel), again = runs
    assert seed in (4, 5) and -1.0 <= sim <= 1.0 and mel.shape[0] == 80
    assert again[:2] == (seed, sim) and np.array_equal(again[2], wav)
    scores = []
    for s in (4, 5):
        [spec] = box.synthesizer.synthesize_spectrograms([TEXT], [utt.embed], seed=s)
        out, _ = ttb.vocode_with_rtf(spec, seed=s)
        processed = tenc.preprocess_wav(np.pad(out.astype(np.float32), (0, 16000)))
        scores.append(float(np.dot(tenc.embed_utterance(processed), utt.embed)))
        if s == seed:
            assert np.array_equal(out, wav) and np.array_equal(spec, mel)
    assert sim == max(scores) and seed == 4 + int(np.argmax(scores))
    assert box.autotune(TEXT, utt, n_seeds=2, start_seed=4)[:2] == (seed, sim)


@pytest.mark.parametrize("shape,width,height", [((5, 8), 16, 4), ((9,), 6, 3), ((80, 37), 50, 4),
                                                ((768,), 100, 3)])
def test_render_heatmap_rows_equal_the_jax_rows(shape, width, height):
    a = np.random.default_rng(sum(shape)).standard_normal(shape)
    assert ttui.render_heatmap(a, width, height) == jtui.render_heatmap(a, width, height)
    assert ttui.render_heatmap(np.ones((4, 4)), 4, 2) == jtui.render_heatmap(np.ones((4, 4)), 4, 2)


def _tree(root: Path) -> Path:
    for spk, f0 in (("spk_a", 140.0), ("spk_b", 230.0)):
        for u in range(2):
            _voice(root / spk / f"utt_{u}.wav", f0 + 20 * u, seed=u)
    return root


def test_tui_screens_equal_the_jax_tuis(tmp_path):
    """Browsing (no model work): the same keys give the same screens."""
    root = _tree(tmp_path / "data")
    states = [mod.TuiState(toolbox=None, datasets_root=root, prompt_fn=lambda label: "")
              for mod in (jtui, ttui)]
    for key in ("", "DOWN", "TAB", "DOWN", "DOWN", "UP", "b", "TAB", "UP", "b", "x"):
        assert [s.handle_key(key) for s in states] == [True, True]
        assert states[0].render(90, 28) == states[1].render(90, 28)
        assert states[1].log == states[0].log
    assert [s.handle_key("q") for s in states] == [False, False]


def test_tui_drives_the_toolbox(box, tmp_path):
    """Enter embeds, s synthesizes, v vocodes and saves, p saves the
    projection, a autotunes over 5 seeds; the saved clone is the bytes the
    toolbox gives again after the same seed."""
    from rtvc_tpu_torch.utils.io import load_wav

    root = _tree(tmp_path / "data")
    tvoc.set_seed(0)
    state = ttui.TuiState(toolbox=box, datasets_root=root,
                          prompt_fn=lambda label: "hello from the terminal")
    for key in ("TAB", "ENTER", "s", "v", "TAB", "DOWN", "TAB", "ENTER", "p", "a"):
        assert state.handle_key(key)
    assert [p.name for p in state.speakers] == ["spk_a", "spk_b"]
    assert state.current.speaker_name == "spk_b" and state.current.embed.shape == (768,)
    assert state.last_spec.shape[0] == 80 and state.last_rtf > 0
    log = "\n".join(state.log)
    assert "loaded + embedded utt_0.wav" in log and "projection →" in log
    assert "autotune best seed" in log, log
    screen = "\n".join(state.render(90, 28))
    assert "embedded: spk_b/utt_0" in screen and "q=quit" in screen
    assert any(c in screen for c in "░▒▓█")
    assert next(box.out_dir.glob("tui_autotune_seed*.wav")).stat().st_size > 1000
    assert state.handle_key("q") is False

    tvoc.set_seed(0)
    spec = box.synthesize("hello from the terminal", box.utterances[0])
    wav, _ = box.vocode(spec)
    saved, _ = load_wav(box.out_dir / "tui_clone.wav")
    replay = box.save_audio(wav, "replay")
    assert replay.read_bytes() == (box.out_dir / "tui_clone.wav").read_bytes()
    assert saved.shape == wav.shape == ((spec.shape[1] - 1) * 200,)


@pytest.fixture
def fresh_modules(models):
    """``demo_toolbox`` installs its own models: the file's come back after."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((tenc, ENC_STATE[0]), (tvoc, ENC_STATE[1])):
            for name in names:
                mp.setattr(mod, name, getattr(mod, name))
        yield


def _demo(tmp_path, *args):
    from rtvc_tpu_torch import demo_toolbox

    demo_toolbox.main(["--cpu", "-o", str(tmp_path / "out"), "-e", str(tmp_path / "none.pt"),
                       *args])


@pytest.mark.parametrize("backend", ["pytorch", "libwavernn"])
def test_demo_toolbox_clones_on_random_weights(fresh_modules, tmp_path, capsys, backend):
    """``clone`` with no checkpoints: random weights, the clone saved; the
    native backend vocodes the random vocoder's RTVCNAT1 export."""
    wav = _voice(tmp_path / "voice.wav", 160.0)
    _demo(tmp_path, "--vocoder_backend", backend, "clone", str(wav), "Hello.", "--seed", "2")
    printed = capsys.readouterr().out
    assert "No trained models found" in printed and "Saved" in printed
    assert (tmp_path / "out" / "clone_voice.wav").stat().st_size > 1000
    assert (tvoc._native is not None) == (backend == "libwavernn")
    assert (tmp_path / "out" / "selftest_vocoder.bin").exists() == (backend == "libwavernn")


def test_demo_toolbox_autotunes_on_random_weights(fresh_modules, tmp_path, capsys):
    wav = _voice(tmp_path / "voice.wav", 160.0)
    _demo(tmp_path, "autotune", str(wav), "Hello.", "--n_seeds", "1")
    printed = capsys.readouterr().out
    assert "seed 0 → voice similarity" in printed and "Best seed 0" in printed
    assert (tmp_path / "out" / "autotune_voice_seed0.wav").stat().st_size > 1000


def test_demo_toolbox_browses_embeds_and_projects(fresh_modules, tmp_path, capsys):
    root = _tree(tmp_path / "data")
    _demo(tmp_path, "-d", str(root), "browse", "--max", "3")
    listed = capsys.readouterr().out.split()
    assert listed == [str(p) for p in sorted(root.glob("**/*.wav"))[:3]]
    wavs = sorted(root.glob("**/*.wav"))
    _demo(tmp_path, "embed", str(wavs[0]))
    _demo(tmp_path, "project", *map(str, wavs[:3]))
    printed = capsys.readouterr().out
    assert "Saved embedding heatmap" in printed and "Saved projection" in printed
    assert (tmp_path / "out" / "embed_utt_0.png").exists()
    assert (tmp_path / "out" / "projection.png").exists()
