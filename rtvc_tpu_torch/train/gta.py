"""Ground-truth-aligned (GTA) synthesis for vocoder training (counterpart of
``rtvc_tpu/train/gta.py``).

Runs a trained synthesizer teacher-forced over the whole synthesizer
dataset and saves its postnet mels, ``mels_gta/<id>.npy``, with
``synthesized.json``: the vocoder then trains on the synthesizer's own
output, artifacts included. Every source of noise is off, so two passes
write the same bits: Tacotron runs ``tacotron_forward(train=False)`` with
both prenets' dropout off and zoneout 0 (one K5 forward launch a batch on
the card, no residual kept under no grad), ForwardTacotron and FastPitch
their teacher-forced forwards with ``train=False``.

One process: the JAX package's split of the batches over processes waits
for the port's multi-GPU slice.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from rtvc_tpu_torch.config import synthesizer_paths
from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models.fast_pitch import fastpitch_forward
from rtvc_tpu_torch.models.forward_tacotron import forward_tacotron_forward
from rtvc_tpu_torch.models.tacotron import tacotron_forward

# the collated batch's keys, in the order the non-autoregressive forwards
# take them after the model
_NAR_KEYS = ("chars", "mels", "durations", "embeds", "spec_lens", "phoneme_pitchs",
             "phoneme_energys")


def gta_forward(bundle: factories.SynModel, batch, r: int) -> torch.Tensor:
    """The postnet mel (B, n_mels, L) of one collated batch, teacher-forced
    with no noise, on the model's device."""
    model = bundle.model
    dev = next(model.parameters()).device

    def tensor(key):
        x = torch.as_tensor(batch[key])
        return x.to(dev, torch.float32 if x.is_floating_point() else torch.long)

    if bundle.model_type == factories.MODEL_TYPE_TACOTRON:
        _, mel_post, _, _, _ = tacotron_forward(
            model, bundle.dims, tensor("chars"), tensor("mels"), tensor("embeds"), r,
            prenet_dropout=False, train=False, encoder_prenet_dropout=False)
        return mel_post
    forward = (forward_tacotron_forward
               if bundle.model_type == factories.MODEL_TYPE_FORWARD_TACOTRON
               else fastpitch_forward)
    return forward(model, *(tensor(k) for k in _NAR_KEYS), train=False)[1]


@torch.no_grad()
def run_synthesis(syn_dir: Path, voc_dir: Path, bundle: factories.SynModel, r: int = 1,
                  batch_size: int = 8, skip_existing: bool = False) -> int:
    """Teacher-forced synthesis over the dataset of ``syn_dir`` into
    ``voc_dir``: each utterance's ``mels_gta/<id>.npy`` (its postnet mel cut
    at its length, (frames, n_mels)) and its ``train.json`` line in
    ``synthesized.json``. Batches come in length order
    (``batch_iterator(shuffle=False, drop_last=False, mel_bucket=2)``);
    ``r`` is Tacotron's reduction factor; the batches' mel lengths are
    padded to a multiple of ``2 r`` for every type, as the JAX package pads
    them. With ``skip_existing`` a batch whose mels all exist is
    skipped and ``synthesized.json`` is merged into. Returns the number of
    utterances synthesized."""
    syn_dir, voc_dir = Path(syn_dir), Path(voc_dir)
    gta_dir = voc_dir / synthesizer_paths.gta_mel_dir
    gta_dir.mkdir(parents=True, exist_ok=True)
    meta_out = voc_dir / synthesizer_paths.gta_metadata_file
    dataset = SynthesizerDataset(syn_dir, factories.get_model_train_elements(bundle.model_type))

    existing = {p.stem for p in gta_dir.glob("*.npy")} if skip_existing else set()
    metadata = json.loads(meta_out.read_text()) if skip_existing and meta_out.exists() else {}
    # utterance id → its train.json line
    src_lines = {line.split("|")[0]: line
                 for lines in json.loads((syn_dir / synthesizer_paths.metadata_file)
                                         .read_text()).values()
                 for line in lines}

    count = 0
    for batch in batch_iterator(dataset, batch_size, r, shuffle=False, drop_last=False,
                                mel_bucket=2):
        ids = [dataset.samples_fnames[i] for i in batch["indices"]]
        if skip_existing and all(u in existing for u in ids):
            continue
        mels = gta_forward(bundle, batch, r).cpu().numpy()
        for b, utt_id in enumerate(ids):
            n = int(batch["spec_lens"][b])
            np.save(gta_dir / f"{utt_id}.npy", mels[b, :, :n].T, allow_pickle=False)
            metadata[utt_id] = src_lines.get(utt_id, f"{utt_id}|{n * 200}|{n}|")
            count += 1
    meta_out.write_text(json.dumps(metadata))
    print("GTA synthesis wrote %d mels to %s" % (count, gta_dir))
    return count
