"""The port's GTA pass against the JAX package (f32 on the CPU, where K3, K4
and K5 run their plain versions and the JAX package its scans), at narrow
widths on the corpus's 80 mels and 768-d embeddings, every dropout of the
configs at 0.5 so that a dropout left on shows:

  * ``train.gta.run_synthesis`` for Tacotron (r 2), ForwardTacotron and
    FastPitch on bridged weights against ``rtvc_tpu.train.gta.run_synthesis``
    on one tiny root the alignment pass wrote: every saved mel within 5e-5
    of JAX's, ``synthesized.json`` equal;
  * two passes equal in bits; ``skip_existing`` writes nothing twice, and
    redoes only a batch with a missing mel, merging ``synthesized.json``;
  * ``tacotron_forward`` with both prenets' dropout off is deterministic,
    and its default keeps the encoder prenet's dropout on;
  * the non-autoregressive forwards with ``train=False`` against JAX's
    ``train=False`` within 2e-5, drawing no dropout and returning no
    statistics;
  * ``python -m rtvc_tpu_torch.vocoder_preprocess`` on a checkpoint, and
    its refusal to run without a card unless told ``--device cpu``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config.synthesizer import FastPitchParams as JFPParams
from rtvc_tpu.config.synthesizer import ForwardTacotronParams as JFTParams
from rtvc_tpu.models import factories as jfactories
from rtvc_tpu.models import fast_pitch as jfp
from rtvc_tpu.models import forward_tacotron as jft
from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.train import gta as jgta
from rtvc_tpu_torch import vocoder_preprocess
from rtvc_tpu_torch.config.synthesizer import FastPitchParams, ForwardTacotronParams
from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.train import gta
from rtvc_tpu_torch.train.checkpoints import save_checkpoint
from test_torch_align import ALIGNER_CFG, aligned_root
from test_torch_fast_pitch import _jax_variables
from test_torch_forward_tacotron import _copy
from test_torch_nar_train import FP_CFG, FT_CFG

REPO = Path(__file__).resolve().parents[1]
TYPES = ("tacotron", "forward-tacotron", "fast-pitch")
NAR_TYPES = TYPES[1:]
R = 2
P = 0.5  # every dropout rate of the narrow configs
CFGS = {
    "tacotron": ALIGNER_CFG.replace(dropout=P),
    "forward-tacotron": ForwardTacotronParams(**FT_CFG).replace(
        duration_dropout=P, pitch_dropout=P, energy_dropout=P, prenet_dropout=P,
        postnet_dropout=P),
    "fast-pitch": FastPitchParams(**FP_CFG).replace(dropout=P, series_dropout=P),
}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Five utterances of 20-22 frames (every batch pads to 24 at r 2), the
    alignment pass's files included."""
    return aligned_root(tmp_path_factory.mktemp("gta") / "syn", 5, frames=(20, 23))


def bundle_of(model_type, seed=0):
    """The port's seeded narrow model (running statistics away from their
    initial values), as a SynModel."""
    b = factories.init_syn_model(model_type, seed=seed, override_hp=CFGS[model_type],
                                 device="cpu")
    g = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for name, buf in b.model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if name.endswith("var")
                      else 0.2 * torch.randn(buf.shape, generator=g))
    return b


def jax_bundle(b):
    """The same weights as the JAX package's SynModel."""
    sd = _copy(b.model.state_dict())
    if b.model_type == "tacotron":
        jd = jt.TacotronDims(**b.dims._asdict())
        v = jt.import_torch_state(sd, jd)
    elif b.model_type == "forward-tacotron":
        jd = jft.ForwardTacotronDims.from_config(JFTParams(**b.config.asdict()),
                                                 b.dims.num_chars, b.dims.n_mels,
                                                 b.dims.speaker_embedding_size)
        v = jft.import_torch_state(sd, jd)
    else:
        jd = jfp.FastPitchDims.from_config(JFPParams(**b.config.asdict()), b.dims.num_chars,
                                           b.dims.n_mels, b.dims.speaker_embedding_size)
        v = _jax_variables(b.model, jd)
    assert tuple(jd) == tuple(b.dims)
    return jfactories.SynModel(b.model_type, jd, v, None)


@pytest.fixture(scope="module")
def bundles():
    return {t: bundle_of(t) for t in TYPES}


def _mels(voc_dir):
    return {p.stem: np.load(p) for p in sorted((voc_dir / "mels_gta").iterdir())}


@pytest.mark.parametrize("model_type", TYPES)
def test_gta_pass_matches_jax(tmp_path, root, bundles, model_type):
    b = bundles[model_type]
    assert gta.run_synthesis(root, tmp_path / "port", b, r=R, batch_size=2) == 5
    assert jgta.run_synthesis(root, tmp_path / "jax", jax_bundle(b), r=R, batch_size=2) == 5
    got, want = _mels(tmp_path / "port"), _mels(tmp_path / "jax")
    assert got.keys() == want.keys() == {f"utt{i:03d}" for i in range(5)}
    for uid, mel in got.items():
        n = np.load(root / "mels" / f"mel-{uid}.npy").shape[0]
        assert mel.shape == want[uid].shape == (n, 80) and mel.dtype == np.float32
        np.testing.assert_allclose(mel, want[uid], atol=5e-5, err_msg=uid)
    meta = [json.loads((tmp_path / d / "synthesized.json").read_text()) for d in ("port", "jax")]
    assert meta[0] == meta[1] and len(meta[0]) == 5
    lines = {line.split("|")[0]: line
             for ls in json.loads((root / "train.json").read_text()).values() for line in ls}
    assert meta[0] == {u: lines[u] for u in meta[0]}


@pytest.mark.parametrize("model_type", TYPES)
def test_gta_pass_is_deterministic(tmp_path, root, bundles, model_type):
    for name in ("a", "b"):
        gta.run_synthesis(root, tmp_path / name, bundles[model_type], r=R, batch_size=2)
    a, b = _mels(tmp_path / "a"), _mels(tmp_path / "b")
    assert a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_skip_existing_writes_nothing_twice(tmp_path, root, bundles):
    b, voc = bundles["tacotron"], tmp_path / "voc"
    gta.run_synthesis(root, voc, b, r=R, batch_size=2)
    files = sorted((voc / "mels_gta").iterdir()) + [voc / "synthesized.json"]
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in files}
    assert gta.run_synthesis(root, voc, b, r=R, batch_size=2, skip_existing=True) == 0
    # the mels untouched; synthesized.json written again with the same bytes
    assert all((p.stat().st_mtime_ns, p.read_bytes()) == before[p] for p in files[:-1])
    assert files[-1].read_bytes() == before[files[-1]][1]
    # a missing mel redoes its batch only, and the metadata is merged into
    dataset = SynthesizerDataset(root, ["mel", "embed"])
    order = [dataset.samples_fnames[i]
             for bt in batch_iterator(dataset, 2, R, shuffle=False, drop_last=False)
             for i in bt["indices"]]
    (voc / "mels_gta" / f"{order[0]}.npy").unlink()
    meta = json.loads((voc / "synthesized.json").read_text())
    (voc / "synthesized.json").write_text(json.dumps({u: meta[u] for u in order[2:]}))
    assert gta.run_synthesis(root, voc, b, r=R, batch_size=2, skip_existing=True) == 2
    assert json.loads((voc / "synthesized.json").read_text()) == meta
    for p in files[:-1]:
        assert p.read_bytes() == before[p][1]
        assert (p.stat().st_mtime_ns == before[p][0]) == (p.stem not in order[:2])


def test_tacotron_forward_dropouts(bundles):
    b = bundles["tacotron"]
    rng = np.random.default_rng(3)
    chars = torch.from_numpy(rng.integers(1, b.dims.num_chars, (2, 16)))
    mels = torch.from_numpy(rng.uniform(-4, 0, (2, 80, 12)).astype(np.float32))
    embeds = torch.from_numpy(rng.standard_normal((2, 768)).astype(np.float32))

    def run(seed, **kw):
        with torch.no_grad():
            return tt.tacotron_forward(b.model, b.dims, chars, mels, embeds, R,
                                       torch.Generator().manual_seed(seed), train=False,
                                       **kw)[1]

    off = dict(prenet_dropout=False, encoder_prenet_dropout=False)
    assert torch.equal(run(1, **off), run(2, **off))
    # the default keeps the encoder prenet's dropout on, drawn from the generator
    assert torch.equal(run(1), run(1, encoder_prenet_dropout=True))
    assert not torch.equal(run(1, prenet_dropout=False), run(2, prenet_dropout=False))
    assert not torch.equal(run(1, prenet_dropout=False), run(1, **off))


@pytest.mark.parametrize("model_type", NAR_TYPES)
def test_nar_eval_forward_matches_jax(root, bundles, model_type):
    b = bundles[model_type]
    jb = jax_bundle(b)
    dataset = SynthesizerDataset(root, factories.get_model_train_elements(model_type))
    batch = next(iter(batch_iterator(dataset, 3, 1, shuffle=False, drop_last=False)))
    keys = ("chars", "mels", "durations", "embeds", "spec_lens", "phoneme_pitchs",
            "phoneme_energys")
    jfwd = jax.jit(jft.forward_tacotron_forward if model_type == "forward-tacotron"
                   else jfp.fastpitch_forward, static_argnums=(1,), static_argnames=("train",))
    want = jfwd(jb.variables, jb.dims, *(jnp.asarray(batch[k]) for k in keys),
                jax.random.PRNGKey(1), train=False)
    buffers = {k: t.clone() for k, t in b.model.named_buffers()}
    args = [torch.as_tensor(batch[k]) for k in keys]
    args = [a.long() if not a.is_floating_point() else a for a in args]
    fwd = gta.forward_tacotron_forward if model_type == "forward-tacotron" \
        else gta.fastpitch_forward
    with torch.no_grad():
        got = fwd(b.model.train(), *args, torch.Generator().manual_seed(1), train=False)
        again = fwd(b.model, *args, torch.Generator().manual_seed(2), train=False)
    b.model.eval()
    for name, a, w, a2 in zip(("mel", "mel_post", "dur", "pitch", "energy"), got, want, again):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
        assert torch.equal(a, a2), name  # no dropout drawn
    assert got[5] == {}
    assert all(torch.equal(t, buffers[k]) for k, t in b.model.named_buffers())


def test_entry_point_on_a_checkpoint(tmp_path, root, bundles):
    b = bundles["tacotron"]
    ckpt = tmp_path / "taco.pt"
    save_checkpoint(ckpt, b.model, 10, "tacotron", extras={"r": R, "config": b.config.asdict()})
    want = tmp_path / "want"
    gta.run_synthesis(root, want, b, r=R)
    out = tmp_path / "voc"
    proc = subprocess.run(
        [sys.executable, "-m", "rtvc_tpu_torch.vocoder_preprocess", str(tmp_path), "-i",
         str(root), "-o", str(out), "-s", str(ckpt), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "GTA synthesis wrote 5 mels" in proc.stdout
    got, expect = _mels(out), _mels(want)
    assert got.keys() == expect.keys() and all(got[k].tobytes() == expect[k].tobytes()
                                               for k in got)
    assert vocoder_preprocess.main([str(tmp_path), "-i", str(root), "-o", str(out), "-s",
                                    str(ckpt), "--device", "cpu", "--skip_existing"]) == 0
    assert vocoder_preprocess.main([str(tmp_path), "--ground_truth"]) == 0
    args = vocoder_preprocess.parse_args([str(tmp_path)])
    assert (args.batch_size, args.syn_model_fpath, args.device) == \
        (8, Path("saved_models/default/synthesizer.ckpt"), "cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            vocoder_preprocess.main([str(tmp_path), "-i", str(root), "-o", str(out), "-s",
                                     str(ckpt)])
