"""The port's alignment pass and GTA pass split over two processes
(``tests/torch_dp_worker.py``'s ``prep`` stage: the group joined from the
``RTVC_*`` environment through ``synthesizer_preprocess_alignments`` and
``vocoder_preprocess``): process p of 2 aligns every second utterance from
the p-th and synthesizes every second batch, and what the two write merges
to what one process writes, as ``tests/test_distributed.py`` holds the JAX
package's passes (the alignment files within atol 1e-5, rtol 1e-4, the GTA
mels within atol 1e-4, rtol 1e-3, ``synthesized.json`` equal)."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from rtvc_tpu_torch.config import synthesizer_paths
from rtvc_tpu_torch.train.checkpoints import save_checkpoint
from test_torch_align import ALIGNER_CFG, narrow_aligner_bundle, write_root
from test_torch_distributed import launch_workers

ALIGN_DIRS = ("duration", "attention", "alignment", "phoneme_pitch", "phoneme_energy")
N_UTTS = 8


@pytest.fixture(scope="module")
def passes(tmp_path_factory):
    """One synthesizer root and Tacotron checkpoint, copied for the two
    processes and for one; both passes run on each copy."""
    base = tmp_path_factory.mktemp("prep_base")
    write_root(base / "syn", N_UTTS)
    save_checkpoint(base / "taco.pt", narrow_aligner_bundle().model, 1, "tacotron",
                    extras={"r": 1, "config": ALIGNER_CFG.asdict()})
    outdir = tmp_path_factory.mktemp("torch_dp_prep")
    one = tmp_path_factory.mktemp("one_process")
    for dest in (outdir / "prep", one):
        shutil.copytree(base, dest, dirs_exist_ok=True)
    launch_workers(outdir, "prep")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        worker.run_passes(one)
    finally:
        torch.set_num_threads(n)
    return outdir / "prep", one


@pytest.mark.parametrize("name", ALIGN_DIRS)
def test_alignment_pass_merges_to_one_process(passes, name):
    two, one = passes
    sub = getattr(synthesizer_paths, f"{name}_dir")
    got = sorted(p.name for p in (two / "syn" / sub).glob("*.npy"))
    want = sorted(p.name for p in (one / "syn" / sub).glob("*.npy"))
    assert got == want and len(got) == N_UTTS
    for f in got:
        np.testing.assert_allclose(np.load(two / "syn" / sub / f), np.load(one / "syn" / sub / f),
                                   atol=1e-5, rtol=1e-4, err_msg=f)


def test_gta_pass_merges_to_one_process(passes):
    two, one = passes
    gta = synthesizer_paths.gta_mel_dir
    got = sorted(p.name for p in (two / "voc" / gta).glob("*.npy"))
    want = sorted(p.name for p in (one / "voc" / gta).glob("*.npy"))
    assert got == want and len(got) == N_UTTS
    for f in got:
        np.testing.assert_allclose(np.load(two / "voc" / gta / f), np.load(one / "voc" / gta / f),
                                   atol=1e-4, rtol=1e-3, err_msg=f)
    meta = synthesizer_paths.gta_metadata_file
    assert json.loads((two / "voc" / meta).read_text()) == \
        json.loads((one / "voc" / meta).read_text())
    # each process wrote its own batches' lines: every second batch of 2
    parts = [json.loads((two / "voc" / f"synthesized.part{p}.json").read_text())
             for p in (0, 1)]
    assert len(parts[0]) == len(parts[1]) == N_UTTS // 2
    assert not set(parts[0]) & set(parts[1])
    assert not (one / "voc" / "synthesized.part0.json").exists()
