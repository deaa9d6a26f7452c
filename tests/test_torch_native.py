"""The native WaveRNN engine in the port: ``native/convert.export_wavernn``
writes from a port state_dict the RTVCNAT1 bytes the JAX ``export_wavernn``
writes from the same weights' variables (every variant, dense and pruned
sparse, f32 and f16: equal bytes); the engine, built by
``_build.build_wavernn_engine`` from the copied sources, decodes greedily as
the port's plain argmax generate does (atol 2e-4 and under 5 % of samples
apart, the rule of ``tests/test_native.py``); the binding's
``vocode_mel`` agrees with the JAX binding's on the same library and
weights (greedy, atol 1e-4: the two de-emphasis filters differ, an f32 scan
against an f64 one); ``inference.vocoder.load_model(voc_type="libwavernn")``
vocodes there, seeded; and the two entry modules."""
import numpy as np
import pytest
import torch

from rtvc_tpu.models import wavernn as jw
from rtvc_tpu.native import convert as jconvert
from rtvc_tpu.native import libwavernn as jlib
from rtvc_tpu_torch import _build
from rtvc_tpu_torch.inference import vocoder as tvoc
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import wavernn as tw
from rtvc_tpu_torch.native import convert as tconvert
from rtvc_tpu_torch.native import libwavernn as tlib
from rtvc_tpu_torch.train import pruning
from rtvc_tpu_torch.train.checkpoints import save_checkpoint

VARIANTS = (("runtimeracer-wavernn", "RAW"), ("fatchord-wavernn", "RAW"),
            ("geneing-wavernn", "BITS"))


def _dims(variant, mode):
    return tw.WaveRNNDims(variant=variant, mode=mode, rnn_dims=16, fc_dims=16, bits=6, pad=2,
                          upsample_factors=(2, 2, 5), feat_dims=10, compute_dims=8,
                          res_out_dims=16, res_blocks=2, hop_length=20, sample_rate=1000)


def _model(variant, mode, pruned=False, seed=0):
    """A seeded port WaveRNN with non-trivial BatchNorm statistics; pruned:
    70 % of the column groups of 4 of every prunable matrix zeroed by the
    port's pruning."""
    d = _dims(variant, mode)
    model = factories.init_wavernn(d, seed=seed, device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5) if name.endswith("var") else buf.normal_(0, 0.2)
        if pruned:
            pruning.apply_prune_masks(model, pruning.compute_prune_masks(
                model, d, 100, 0, 100, 0.7, 0.7, 4))
    return d, model


@pytest.fixture(scope="module")
def engine():
    """The engine built once for the file (≈ 5-10 s with g++)."""
    return _build.build_wavernn_engine()


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread: beside other test workers more OpenMP threads
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_vocoder(monkeypatch):
    for name in ("_bundle", "_native", "_seed", "_gen_counter"):
        monkeypatch.setattr(tvoc, name, getattr(tvoc, name))


def test_engine_builds_into_the_port_by_hash(engine):
    assert engine.library.parent == engine.cli.parent == _build.BUILD_DIR
    assert engine.library.is_file() and engine.cli.is_file()
    assert engine == _build.wavernn_engine_paths() == _build.build_wavernn_engine()
    assert engine.library.name.startswith("librtvc_wavernn_")


def test_loading_the_engine_keeps_subnormal_floats(engine):
    """The library is compiled with -ffast-math but not linked with it: its
    load must not turn on flush-to-zero for the process that loads it (in a
    fresh process, so that no other test's state counts)."""
    import subprocess
    import sys

    code = ("import ctypes, sys, numpy as np, torch\n"
            "ctypes.CDLL(sys.argv[1])\n"
            "x = np.float32(1e-39) * np.float32(1.0)\n"
            "t = float(torch.tensor(1e-39, dtype=torch.float32) * 1.0)\n"
            "sys.exit(0 if x != 0 and t != 0 else 1)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(engine.library)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("weight_dtype", ["f32", "f16"])
@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("variant,mode", VARIANTS)
def test_export_equals_the_jax_export_in_bytes(tmp_path, variant, mode, pruned, weight_dtype):
    d, model = _model(variant, mode, pruned)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = jw.import_torch_state(sd, jw.WaveRNNDims(**d._asdict()))
    jconvert.export_wavernn(variables, jw.WaveRNNDims(**d._asdict()), tmp_path / "jax.bin",
                            weight_dtype=weight_dtype)
    tconvert.export_wavernn(model, d, tmp_path / "port.bin", weight_dtype=weight_dtype)
    tconvert.export_wavernn(sd, d, tmp_path / "port_sd.bin", weight_dtype=weight_dtype)
    want = (tmp_path / "jax.bin").read_bytes()
    assert (tmp_path / "port.bin").read_bytes() == want
    assert (tmp_path / "port_sd.bin").read_bytes() == want
    assert want[:8] == b"RTVCNAT1"
    # the pruned matrices went into group-sparse storage: the file is shorter
    # than the same weights stored dense
    tconvert.export_wavernn(model, d, tmp_path / "dense.bin", sparse_threshold=2.0,
                            weight_dtype=weight_dtype)
    dense = (tmp_path / "dense.bin").read_bytes()
    assert len(want) < len(dense) if pruned else want == dense


def _plain_argmax(model, d, mel):
    """The port's greedy sample loop over one unfolded sequence (the plain
    version of K1 on the CPU)."""
    mels = torch.nn.functional.pad(torch.from_numpy(mel[None]), (d.pad, d.pad))
    with torch.no_grad():
        mu, aux, _ = tw.upsample_forward(model, d, mels)
        return tw.generate_core(model, d, mu, aux, seed=0, argmax=True)[0].numpy()


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("variant,mode", VARIANTS)
def test_engine_argmax_decode_matches_the_plain_generate(engine, tmp_path, variant, mode,
                                                          pruned):
    d, model = _model(variant, mode, pruned)
    tconvert.export_wavernn(model, d, tmp_path / "model.bin")
    mel = np.random.default_rng(0).uniform(-1, 1, (d.feat_dims, 12)).astype(np.float32)
    want = _plain_argmax(model, d, mel)
    inst = tlib._Instance(tlib._load_lib(), tmp_path / "model.bin")
    inst.set_seed(3)
    got = inst.mel_to_wav(mel, argmax=True)
    assert got.shape == want.shape == (12 * d.hop_length,)
    mismatches = np.mean(got != want.astype(np.float32))
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert mismatches < 0.05 or np.allclose(got, want, atol=1e-5)


def test_engine_sampling_is_seeded(engine, tmp_path):
    d, model = _model(*VARIANTS[0])
    tconvert.export_wavernn(model, d, tmp_path / "model.bin")
    mel = np.random.default_rng(1).uniform(-1, 1, (d.feat_dims, 8)).astype(np.float32)
    lib = tlib._load_lib()
    out = []
    for seed in (42, 42, 43):
        inst = tlib._Instance(lib, tmp_path / "model.bin")
        inst.set_seed(seed)
        out.append(inst.mel_to_wav(mel))
    assert np.array_equal(out[0], out[1]) and not np.array_equal(out[0], out[2])


@pytest.mark.parametrize("batch", [1, 3])
def test_vocode_mel_matches_the_jax_binding(engine, tmp_path, monkeypatch, batch):
    """Fold by the worker pool, the chunks on two threads (and in lockstep
    at batch 3), crossfade, mu-law decode, de-emphasis, fade-out: the port's
    copy against the JAX package's binding on the same library, greedy."""
    d, model = _model(*VARIANTS[0])
    tconvert.export_wavernn(model, d, tmp_path / "model.bin")
    load = jlib._load_lib
    monkeypatch.setattr(jlib, "_load_lib", lambda: load(engine.library))
    cfg = dict(gen_target=200, gen_overlap=100, bits=6)
    monkeypatch.setattr(jlib.voc_cfg, "wavernn_runtimeracer",
                        jlib.voc_cfg.wavernn_runtimeracer.replace(**cfg))
    monkeypatch.setattr(tlib.voc_cfg, "wavernn_runtimeracer",
                        tlib.voc_cfg.wavernn_runtimeracer.replace(**cfg))
    mel = np.random.default_rng(2).uniform(-4, 4, (d.feat_dims, 90)).astype(np.float32)
    out = []
    for mod in (jlib, tlib):
        voc = mod.Vocoder(tmp_path / "model.bin", verbose=False, batch=batch)
        voc.load(n_threads=2)
        out.append(voc.vocode_mel(mel, argmax=True))
    want, got = out
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (89 * 20,)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _voc_checkpoint(tmp_path):
    cfg = factories.default_config("runtimeracer-wavernn").replace(
        rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=16, res_blocks=1, bits=6)
    voc = factories.init_voc_model("runtimeracer-wavernn", seed=5, override_hp=cfg,
                                   device="cpu")
    save_checkpoint(tmp_path / "voc.pt", voc.model, 7, "runtimeracer-wavernn",
                    extras={"config": cfg.asdict()})
    return voc


def test_vocoder_module_runs_the_native_backend(engine, tmp_path):
    """``load_model(voc_type="libwavernn")`` installs the engine: it is the
    vocoder (``is_loaded``), ``infer_waveform`` goes there ((T - 1)·hop
    samples, the same after the same ``set_seed``), ``warmup`` refuses it
    and ``load_bundle`` takes it out again."""
    from rtvc_tpu_torch import vocoder_convert_model

    voc = _voc_checkpoint(tmp_path)
    out = vocoder_convert_model.main([str(tmp_path / "voc.pt"), "-o", str(tmp_path / "v.bin")])
    tconvert.export_wavernn(voc.model, voc.dims, tmp_path / "direct.bin")
    assert out.read_bytes() == (tmp_path / "direct.bin").read_bytes()

    tvoc.load_model(out, voc_type="libwavernn", verbose=False)
    assert tvoc.is_loaded() and tvoc._bundle is None and tvoc._native is not None
    mel = np.random.default_rng(3).uniform(-4, 0, (80, 30)).astype(np.float32)
    tvoc.set_seed(9)
    a = tvoc.infer_waveform(mel)
    tvoc.set_seed(9)
    b = tvoc.infer_waveform(mel)
    assert a.shape == (29 * 200,) and np.isfinite(a).all() and np.array_equal(a, b)
    with pytest.raises(RuntimeError, match="native engine"):
        tvoc.warmup()
    with pytest.raises(NotImplementedError):
        tvoc.load_model(out, voc_type="onnx")
    tvoc.load_bundle(voc)
    assert tvoc._native is None and tvoc.is_loaded()


def test_check_entry_point_writes_the_engines_wav(engine, tmp_path):
    from rtvc_tpu_torch import vocoder_check_libwavernn
    from rtvc_tpu_torch.utils.io import load_wav

    voc = _voc_checkpoint(tmp_path)
    tconvert.export_wavernn(voc.model, voc.dims, tmp_path / "v.bin")
    mel = np.random.default_rng(4).uniform(-4, 0, (25, 80)).astype(np.float32)  # (T, 80)
    np.save(tmp_path / "mel.npy", mel)
    wav = vocoder_check_libwavernn.main([str(tmp_path / "v.bin"), str(tmp_path / "mel.npy"),
                                         "-o", str(tmp_path / "out.wav"), "--seed", "5"])
    voc = tlib.Vocoder(tmp_path / "v.bin", verbose=False)
    voc.load()
    voc.setRandomSeed(5)
    assert np.array_equal(wav, voc.vocode_mel(mel.T)) and wav.shape == (24 * 200,)
    written, sr = load_wav(tmp_path / "out.wav")
    assert sr == 16000 and written.shape == wav.shape


def test_demo_cli_selftest_on_the_native_engine(engine, tmp_path, monkeypatch, capsys):
    """``demo_cli --voc_backend libwavernn`` loads the vocoder file into the
    engine and passes its self-test (the vocoder's on the engine)."""
    from rtvc_tpu_torch import demo_cli
    from rtvc_tpu_torch.config.encoder import EncoderDataParams
    from rtvc_tpu_torch.inference import encoder as tenc
    from rtvc_tpu_torch.inference import synthesizer as tsyn
    from test_torch_clone import ENC, SYN

    for mod, names in ((tenc, ("_model", "_model_cfg", "_data")), (tsyn, ("_model",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    enc = factories.init_encoder_model(1, "cpu", ENC)
    save_checkpoint(tmp_path / "enc.pt", enc, 3, "speaker_encoder",
                    extras={"config": {"model": ENC.asdict(),
                                       "data": EncoderDataParams().asdict()}})
    syn = factories.init_syn_model("tacotron", seed=2, override_hp=SYN, device="cpu")
    save_checkpoint(tmp_path / "syn.pt", syn.model, 4, "tacotron",
                    extras={"r": 2, "config": SYN.asdict()})
    voc = _voc_checkpoint(tmp_path)
    tconvert.export_wavernn(voc.model, voc.dims, tmp_path / "voc.bin")
    demo_cli.main(["--selftest", "--cpu", "--voc_backend", "libwavernn", "-e",
                   str(tmp_path / "enc.pt"), "-s", str(tmp_path / "syn.pt"), "-v",
                   str(tmp_path / "voc.bin")])
    assert "All test passed" in capsys.readouterr().out
    assert tvoc._native is not None and tvoc._bundle is None
