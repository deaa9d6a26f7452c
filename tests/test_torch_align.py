"""The port's alignment pass against the JAX package (f32 on the CPU, where
the Tacotron decoder chain runs K5's plain version and the JAX package its
hoisted scan):

  * ``tacotron_forward(train=False)`` (running statistics, no zoneout, no
    new statistics): mel, linear, attention and stop within 2e-5 of JAX's
    ``train=False``;
  * the copies ``shortest_monotonic_path``, ``DurationExtractor``,
    ``attention_scores`` and ``estimate_f0``: equal to JAX's on seeded
    inputs;
  * ``create_align_features`` on a tiny on-disk root through the port's
    ``TacotronAligner`` and through JAX's ``TacotronAligner(bundle=...)`` on
    the same weights: durations, pitch and energy equal, attention and
    alignment scores within 1e-5; the aligner read from a checkpoint gives
    the same attention; ``python -m
    rtvc_tpu_torch.synthesizer_preprocess_alignments`` writes the five
    files, and raises without a card unless told ``--device cpu``.

``aligned_root`` builds such a root for the non-autoregressive trainers'
tests (``test_torch_nar_train``).
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.data import duration_extractor as jdur
from rtvc_tpu.data import synthesizer_preprocess as jprep
from rtvc_tpu.inference.attention import TacotronAligner as JAligner
from rtvc_tpu.models import factories as jfactories
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.ops import pitch as jpitch
from rtvc_tpu_torch import synthesizer_preprocess_alignments
from rtvc_tpu_torch.config import synthesizer_paths
from rtvc_tpu_torch.config.synthesizer import TacotronParams
from rtvc_tpu_torch.data import duration_extractor as tdur
from rtvc_tpu_torch.data import synthesizer_preprocess as tprep
from rtvc_tpu_torch.inference.attention import TacotronAligner
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.ops import pitch as tpitch
from rtvc_tpu_torch.train.checkpoints import save_checkpoint
from test_torch_taco_train import DIMS, _torch_batch

REPO = Path(__file__).resolve().parents[1]
# a narrow Tacotron at the corpus's 80 mels and 768-d embeddings, dropout 0
ALIGNER_CFG = TacotronParams(embed_dims=16, encoder_dims=16, decoder_dims=32, postnet_dims=16,
                             encoder_K=4, lstm_dims=32, postnet_K=4, num_highways=2, dropout=0.0)
FILES = (("duration", "duration"), ("attention", "attention"), ("alignment", "alignment"),
         ("phoneme_pitch", "phoneme-pitch"), ("phoneme_energy", "phoneme-energy"))


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval_setup(seed=2, B=3, T=11, steps=12):
    """The port's seeded narrow Tacotron (dropout 0; running statistics
    away from their initial values), its JAX variables through the JAX
    package's importer, and a seeded batch."""
    jd, td = jt.TacotronDims(**DIMS), tt.TacotronDims(**DIMS)
    model = factories.init_tacotron(td, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if name.endswith("var")
                      else 0.2 * torch.randn(buf.shape, generator=g))
    v = jt.import_torch_state({k: t.clone() for k, t in model.state_dict().items()}, jd)
    rng = np.random.default_rng(seed)
    lens = rng.integers(T - 4, T + 1, B)
    chars = np.where(np.arange(T)[None, :] < lens[:, None],
                     rng.integers(1, DIMS["num_chars"], (B, T)), 0).astype(np.int32)
    batch = {"chars": chars,
             "mels": rng.uniform(-4, 4, (B, DIMS["n_mels"], steps)).astype(np.float32),
             "embeds": rng.standard_normal((B, 32)).astype(np.float32)}
    return jd, td, v, model, batch


@pytest.mark.parametrize("r", [1, 3])
def test_tacotron_forward_eval_matches_jax(r):
    jd, td, v, model, batch = _eval_setup()
    jfwd = jax.jit(jt.tacotron_forward, static_argnums=(1, 5),
                   static_argnames=("train", "hoisted", "fused"))
    want = jfwd(v, jd, jnp.asarray(batch["chars"]), jnp.asarray(batch["mels"]),
                jnp.asarray(batch["embeds"]), r, jax.random.PRNGKey(1), train=False,
                hoisted=True, fused=False)
    b = _torch_batch(batch)
    buffers = {k: t.clone() for k, t in model.named_buffers()}
    with torch.no_grad():
        got = tt.tacotron_forward(model, td, b["chars"], b["mels"], b["embeds"], r,
                                  torch.Generator().manual_seed(1), train=False)
    for name, a, w in zip(("mel", "linear", "attn", "stop"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
    # JAX's eval mode returns the running statistics it was given; the
    # port's returns none to install
    assert got[4] == {}
    assert all(torch.equal(t, buffers[k]) for k, t in model.named_buffers())


def test_duration_copies_equal_their_originals():
    rng = np.random.default_rng(5)
    for T, C in ((1, 1), (7, 3), (40, 12), (33, 33)):
        cost = rng.uniform(0, 1, (T, C))
        np.testing.assert_array_equal(tdur.shortest_monotonic_path(cost),
                                      jdur.shortest_monotonic_path(cost))
    att = rng.dirichlet(np.ones(12), 40)
    att[:, 3] += 0.5 * (np.arange(40) // 4 == 3)
    tokens = rng.integers(0, 60, 12)
    tokens[[2, 7]] = tdur.silent_phonemes_indices[:2]
    mel = rng.uniform(-14, -8, (80, 40))
    for shift in (0.0, 0.25):
        want = jdur.DurationExtractor(-11.0, shift)(tokens, mel, att)
        got = tdur.DurationExtractor(-11.0, shift)(tokens, mel, att)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[0].sum() == 40
    batch = rng.dirichlet(np.ones(9), (3, 20))
    for r in (1, 2):
        for a, w in zip(tdur.attention_scores(batch, np.array([20, 13, 1]), r),
                        jdur.attention_scores(batch, np.array([20, 13, 1]), r)):
            np.testing.assert_array_equal(a, w)


def test_estimate_f0_copy_equals_its_original():
    rng = np.random.default_rng(6)
    t = np.arange(9000) / 16000
    f = 140 + 40 * np.sin(2 * np.pi * 1.5 * t)
    wav = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / 16000) + 0.01 * rng.standard_normal(len(t))
    wav[4000:5000] = 0.0  # an unvoiced stretch
    for smooth in (True, False):
        got = tpitch.estimate_f0(wav, 16000, 200, smooth=smooth)
        np.testing.assert_array_equal(got, jpitch.estimate_f0(wav, 16000, 200, smooth=smooth))
    assert (got > 0).sum() > 20 and (got == 0).sum() > 3


# ---------------------------------------------------------------------------
# The pass on a tiny on-disk root
# ---------------------------------------------------------------------------


def write_root(root, n_utts, frames=(20, 31), seed=0):
    """A synthesizer root of ``n_utts`` seeded utterances (a tone a wav, an
    80-band mel in [-4, 0], a unit 768-d embedding, a short text) and its
    ``train.json``, as the audio and embedding passes leave it."""
    rng = np.random.default_rng(seed)
    for d in ("wav", "mels", "embeds"):
        (root / d).mkdir(parents=True, exist_ok=True)
    meta = {}
    for i in range(n_utts):
        uid = f"utt{i:03d}"
        n = int(rng.integers(*frames))
        t = np.arange(n * 200) / 16000
        wav = (0.5 * np.sin(2 * np.pi * rng.uniform(100, 250) * t)).astype(np.float32)
        np.save(root / "wav" / f"audio-{uid}.npy", wav)
        np.save(root / "mels" / f"mel-{uid}.npy",
                rng.uniform(-4, 0, (n, 80)).astype(np.float32))
        e = rng.standard_normal(768).astype(np.float32)
        np.save(root / "embeds" / f"embed-{uid}.npy", e / np.linalg.norm(e))
        text = ["hello there", "a short one", "voice clone"][i % 3] + f" {i}"
        meta.setdefault(f"spk{i % 2}", []).append(f"{uid}|{n * 200}|{n}|{text}")
    (root / "train.json").write_text(json.dumps(meta))
    return root


def narrow_aligner_bundle(seed=0):
    """The narrow Tacotron with running statistics away from their initial
    values."""
    bundle = factories.init_syn_model("tacotron", seed=seed, override_hp=ALIGNER_CFG,
                                      device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in bundle.model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if name.endswith("var")
                      else 0.2 * torch.randn(buf.shape, generator=g))
    return bundle


def aligned_root(root, n_utts, frames=(20, 31)):
    """``write_root`` then the port's alignment pass with the narrow
    Tacotron: a root the non-autoregressive trainers read."""
    write_root(root, n_utts, frames)
    tprep.create_align_features(root, aligner=TacotronAligner(bundle=narrow_aligner_bundle()))
    return root


def _read(root, uid):
    return [np.load(root / d / f"{stem}-{uid}.npy") for d, stem in FILES]


def test_create_align_features_matches_jax(tmp_path):
    bundle = narrow_aligner_bundle()
    jd = jt.TacotronDims(**bundle.dims._asdict())
    v = jt.import_torch_state({k: t.clone() for k, t in bundle.model.state_dict().items()}, jd)
    roots = [write_root(tmp_path / name, 3) for name in ("port", "jax")]
    assert tprep.create_align_features(roots[0], aligner=TacotronAligner(bundle=bundle)) == 3
    jprep.create_align_features(roots[1], None, batch_hook=JAligner(
        bundle=jfactories.SynModel("tacotron", jd, v, None)))
    for i in range(3):
        got, want = _read(roots[0], f"utt{i:03d}"), _read(roots[1], f"utt{i:03d}")
        np.testing.assert_array_equal(got[0], want[0])
        n = np.load(roots[0] / "mels" / f"mel-utt{i:03d}.npy").shape[0]
        assert got[0].dtype == np.int64 and got[0].sum() == n
        for a, w in zip(got[1:3], want[1:3]):
            assert a.shape == () and abs(float(a) - float(w)) <= 1e-5
        for a, w in zip(got[3:], want[3:]):
            np.testing.assert_array_equal(a, w)
        assert (got[3] > 0).any() and (got[4] > 0).all() == (got[0] > 0).all()


def test_aligner_from_checkpoints_and_entry_point(tmp_path):
    bundle = narrow_aligner_bundle(seed=3)
    root = write_root(tmp_path / "syn", 2)
    tokens = np.arange(1, 14)
    mel = np.load(root / "mels" / "mel-utt000.npy").T
    embed = np.load(root / "embeds" / "embed-utt000.npy")
    want = TacotronAligner(bundle=bundle).attention(tokens, mel, embed)
    assert want.shape == (mel.shape[1], 13)
    # the pad characters of the 16 bucket take a share of every row
    assert np.isfinite(want).all() and (want.sum(axis=1) <= 1 + 1e-6).all()
    ckpt = tmp_path / "taco.pt"
    save_checkpoint(ckpt, bundle.model, 40, "tacotron", extras={"config": ALIGNER_CFG.asdict()})
    got = TacotronAligner(ckpt, device="cpu").attention(tokens, mel, embed)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="needs a Tacotron"):
        TacotronAligner(bundle=factories.init_syn_model("fast-pitch", device="cpu"))

    proc = subprocess.run(
        [sys.executable, "-m", "rtvc_tpu_torch.synthesizer_preprocess_alignments", str(root),
         "-m", str(ckpt), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "Aligned 2 utterances." in proc.stdout
    for d, stem in FILES:
        assert sorted(p.name for p in (root / getattr(synthesizer_paths, f"{d}_dir")).iterdir()) \
            == [f"{stem}-utt000.npy", f"{stem}-utt001.npy"]
    assert synthesizer_preprocess_alignments.main([str(root), "-m", str(ckpt), "-s",
                                                   "--device", "cpu"]) == 0


def test_entry_points_need_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = write_root(tmp_path / "syn", 1)
    ckpt = tmp_path / "taco.pt"
    save_checkpoint(ckpt, narrow_aligner_bundle().model, 1, "tacotron",
                    extras={"config": ALIGNER_CFG.asdict()})
    with pytest.raises((RuntimeError, AssertionError)):
        synthesizer_preprocess_alignments.main([str(root), "-m", str(ckpt)])
    from rtvc_tpu_torch import synthesizer_train

    aligned = aligned_root(tmp_path / "aligned", 16)
    for model_type in ("forward-tacotron", "fast-pitch"):
        with pytest.raises((RuntimeError, AssertionError)):
            synthesizer_train.main(["run", model_type, str(aligned), "-m",
                                    str(tmp_path / "models")])
