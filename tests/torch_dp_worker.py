"""Worker process of the port's multi-process data-parallel tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_distributed_passes.py``).

    python tests/torch_dp_worker.py <process_id> <num_processes> <port> <outdir> <stages>

It imports ``rtvc_tpu_torch`` only (``tests/dp_worker.py`` imports JAX),
joins a gloo group on ``127.0.0.1:<port>`` on the CPU and runs the stages
named, comma separated:

  * ``enc`` — 3 steps of ``train_encoder`` on this rank's rows of seeded
    GE2E batches, saving every step (only rank 0 may write), and a
    ``fetch`` of two rows holding the rank;
  * ``taco`` / ``fwd`` / ``fast`` — 2 steps of ``train_synthesizer`` for
    Tacotron, ForwardTacotron and FastPitch at narrow widths with their
    dropouts (and Tacotron's zoneout) on: the masks are drawn for the global
    batch;
  * ``voc`` — 3 steps of ``train_vocoder`` (fatchord, RAW) with pruning from
    step 0; once the group is destroyed, the training forward of the model
    it returned, in this process alone, on ``VOC_B // (pid + 1)`` rows of
    the global batch (``alone_<pid>.pt``);
  * ``jax_enc`` / ``jax_taco`` — one GE2E step and one Tacotron step from the
    weights and the global batch in ``<outdir>/jax_inputs.pt`` (the test
    carries them over from the JAX package), dumping what the step's
    parity test reads;
  * ``prep`` — the alignment pass and the GTA pass over the synthesizer root
    ``<outdir>/prep/syn`` from ``<outdir>/prep/taco.pt``, through their entry
    modules, with the group named by the ``RTVC_*`` environment.

Every stage's final parameters and buffers go to ``<outdir>/<stage>_<pid>.pt``.
The single-process runs the tests compare with call the same functions with
``dp=None`` on the whole global batch.
"""
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rtvc_tpu_torch.config import synthesizer as syn_cfg  # noqa: E402
from rtvc_tpu_torch.config import vocoder as voc_cfg  # noqa: E402
from rtvc_tpu_torch.config.encoder import EncoderModelParams  # noqa: E402

ENC = dict(S=4, U=3, T=12)
ENC_MODEL = EncoderModelParams(model_hidden_size=16, model_embedding_size=16,
                               model_num_layers=2)
ENC_STEPS = 3
SYN_STEPS = 2
SYN_B, SYN_TEXT, TACO_R = 4, 12, 2
VOC_STEPS = 3
VOC_B = 4

TACO_CFG = syn_cfg.tacotron.replace(
    embed_dims=8, encoder_dims=4, decoder_dims=8, postnet_dims=4, encoder_K=2, lstm_dims=8,
    postnet_K=2, num_highways=1, tts_schedule=((TACO_R, 1, SYN_B, 1e-3, 1e-4),))
FWD_CFG = syn_cfg.forward_tacotron.replace(
    embed_dims=16, series_embed_dims=8, duration_conv_dims=12, duration_rnn_dims=8,
    pitch_conv_dims=12, pitch_rnn_dims=8, energy_conv_dims=12, energy_rnn_dims=8,
    prenet_dims=16, prenet_k=2, prenet_num_highways=1, rnn_dims=16, postnet_dims=12,
    postnet_k=2, postnet_num_highways=1, pitch_zoneout=0.3, energy_zoneout=0.3,
    tts_schedule=((1, SYN_B, 1e-3, 1e-4),))
FAST_CFG = syn_cfg.fast_pitch.replace(
    embed_dims=16, n_heads=2, conv_dims=24, n_layers_enc=1, n_layers_dec=1,
    series_d_model=8, series_n_heads=2, series_layers=1, series_d_fft=12,
    tts_schedule=((1, SYN_B, 1e-3, 1e-4),))
SYN_CFGS = {"taco": ("tacotron", TACO_CFG), "fwd": ("forward-tacotron", FWD_CFG),
            "fast": ("fast-pitch", FAST_CFG)}
VOC_CFG = voc_cfg.wavernn_fatchord.replace(
    rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=16, res_blocks=1, bits=6,
    seq_len=400, use_sparsification=True, start_prune=0, prune_steps=4, sparsity_target=0.5,
    sparsity_target_rnn=0.5, voc_tts_schedule=((1, 1e-3, 1e-4, VOC_B),))


def rows(n: int, pid: int, nproc: int) -> slice:
    """Process ``pid``'s contiguous rows of a global batch of ``n``."""
    local = n // nproc
    return slice(pid * local, (pid + 1) * local)


def local_rows(batch, part: slice):
    return batch if part is None else {k: v[part] for k, v in batch.items()}


def enc_batch(step: int) -> np.ndarray:
    """A seeded GE2E batch (S·U, T, 40): each speaker's frames scatter
    around a signature of their own."""
    S, U, T = ENC["S"], ENC["U"], ENC["T"]
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((S, 1, 1, 40)) + 0.3 * rng.standard_normal((S, U, T, 40))
            ).reshape(S * U, T, 40).astype(np.float32)


def run_encoder(models_dir: Path, part=None, dp=None):
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.trainer import train_encoder

    def batches():
        for step in range(ENC_STEPS):
            b = enc_batch(step)
            yield b if part is None else b[part]

    model = factories.init_encoder_model(seed=0, device="cpu", model_cfg=ENC_MODEL)
    return train_encoder("dprun", batches(), models_dir, speakers_per_batch=ENC["S"],
                         utterances_per_speaker=ENC["U"], learning_rate=1e-3,
                         total_steps=ENC_STEPS, save_every=1, backup_every=0, eer_every=1,
                         resume=False, model=model, device="cpu", dp=dp)


def syn_batch(model_type: str) -> dict:
    """A seeded global batch as ``collate_synthesizer`` gives it: texts of
    several lengths, mels in [-4, 0]; for the non-autoregressive types
    durations summing to each row's frames, pitch and energy."""
    rng = np.random.default_rng(7)
    B, T = SYN_B, SYN_TEXT
    frames = 4 * TACO_R * 3
    x_lens = np.array([12, 10, 7, 11])
    chars = np.where(np.arange(T)[None, :] < x_lens[:, None],
                     rng.integers(1, 40, (B, T)), 0).astype(np.int64)
    batch = {"chars": chars,
             "mels": rng.uniform(-4, 0, (B, 80, frames)).astype(np.float32),
             "embeds": rng.standard_normal((B, 768)).astype(np.float32)}
    spec_lens = np.array([frames, frames - 3, frames - 7, frames - 2])
    if model_type == "tacotron":
        batch["stop"] = (np.arange(frames)[None, :] >= spec_lens[:, None] - 1).astype(
            np.float32)
        return batch
    durations = np.zeros((B, T), np.float32)
    for b in range(B):
        cuts = np.sort(rng.integers(0, spec_lens[b] + 1, x_lens[b] - 1))
        durations[b, :x_lens[b]] = np.diff(np.concatenate([[0], cuts, [spec_lens[b]]]))
    return {**batch, "durations": durations, "spec_lens": spec_lens.astype(np.int64),
            "x_lens": x_lens.astype(np.int64),
            "phoneme_pitchs": np.where(durations > 0, rng.uniform(0, 2, (B, T)), 0).astype(
                np.float32),
            "phoneme_energys": np.where(durations > 0, rng.uniform(0, 2, (B, T)), 0).astype(
                np.float32)}


def run_synthesizer(stage: str, models_dir: Path, part=None, dp=None):
    from rtvc_tpu_torch.train.trainer import train_synthesizer

    model_type, cfg = SYN_CFGS[stage]
    batch = local_rows(syn_batch(model_type), part)
    return train_synthesizer(f"{stage}run", model_type, models_dir,
                             lambda session, r: [batch] * SYN_STEPS, save_every=0, seed=3,
                             override_hp=cfg, resume=False, device="cpu", dp=dp)


def voc_batch() -> dict:
    cfg = VOC_CFG
    rng = np.random.default_rng(13)
    B, seq = VOC_B, cfg.seq_len
    labels = rng.integers(0, 2 ** cfg.bits, (B, seq + 1))
    return {"x": (labels[:, :-1] * 2.0 / (2 ** cfg.bits - 1) - 1).astype(np.float32),
            "y": labels[:, 1:].astype(np.int64),
            "mels": rng.uniform(0, 1, (B, 80, seq // 200 + 2 * cfg.pad)).astype(np.float32)}


def run_vocoder(models_dir: Path, part=None, dp=None):
    from rtvc_tpu_torch.train.trainer import train_vocoder

    batch = local_rows(voc_batch(), part)
    return train_vocoder("vocrun", "fatchord-wavernn", models_dir,
                         lambda session: [batch] * VOC_STEPS, save_every=0, seed=5,
                         override_hp=VOC_CFG, resume=False, device="cpu", dp=dp)


def vocoder_loss_alone(model, n_rows: int) -> float:
    """The loss of ``model``'s teacher-forced forward (the BatchNorms on
    batch statistics) on the first ``n_rows`` rows of the global vocoder
    batch, outside any step."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.models.wavernn import wavernn_forward
    from rtvc_tpu_torch.train.losses import cross_entropy_bits

    b = {k: torch.from_numpy(v[:n_rows]) for k, v in voc_batch().items()}
    with torch.no_grad():
        out, _ = wavernn_forward(model, factories.wavernn_dims("fatchord-wavernn", VOC_CFG),
                                 b["x"], b["mels"])
    return float(cross_entropy_bits(out, b["y"]))


def pruned_fraction(model) -> float:
    """The share of zeros among the weights pruning acts on."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.pruning import prunable_weights

    params = dict(model.named_parameters())
    names = [n for n, _ in prunable_weights(factories.wavernn_dims("fatchord-wavernn",
                                                                   VOC_CFG))]
    zeros = sum(int((params[n] == 0).sum()) for n in names)
    return zeros / sum(params[n].numel() for n in names)


def jax_encoder_step(inputs: dict, part=None, dp=None) -> dict:
    """One GE2E step from the carried-over weights on this rank's speakers:
    the loss, the gradient norm, the (global) similarity matrix and every
    gradient the optimizer applied."""
    from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from rtvc_tpu_torch.train.steps import make_encoder_train_step
    from rtvc_tpu_torch.train.trainer import make_optimizer

    S, U = inputs["enc_shape"]
    model = SpeakerEncoder(inputs["enc_cfg"])
    model.load_state_dict(inputs["enc_state"])
    frames = inputs["enc_frames"]
    step = make_encoder_train_step(model, make_optimizer(model.parameters(), 1e-3), S, U,
                                   dp=dp)
    loss, gnorm, sim, _ = step(torch.from_numpy(frames if part is None else frames[part]))
    return {"loss": loss, "grad_norm": gnorm, "sim": sim,
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}


def jax_tacotron_step(inputs: dict, part=None, dp=None) -> dict:
    """One Tacotron step from the carried-over weights on this rank's rows,
    zoneout 0 (dropout 0 in the dims): the statistics, this rank's
    attention, every gradient applied, and the state after the step."""
    from rtvc_tpu_torch.models import tacotron as tt
    from rtvc_tpu_torch.train.steps import make_tacotron_train_step
    from rtvc_tpu_torch.train.trainer import make_optimizer

    d = tt.TacotronDims(**inputs["taco_dims"])
    model = tt.Tacotron(d)
    model.load_state_dict(inputs["taco_state"])
    batch = local_rows(inputs["taco_batch"], part)
    r, steps = inputs["taco_r"], batch["mels"].shape[2]
    B = batch["mels"].shape[0]
    step = make_tacotron_train_step(model.train(), d,
                                    make_optimizer(model.parameters(), 1e-3), r, 1.0, dp=dp)
    zero = torch.zeros(steps // r, B, d.lstm_dims)
    stats, attn = step({k: torch.from_numpy(v) for k, v in batch.items()},
                       zoneout_masks=(zero, zero))
    return {"stats": stats, "attn": attn,
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def run_passes(prep: Path, device="cpu"):
    """The alignment pass, then the GTA pass at batch 2, through their entry
    modules."""
    from rtvc_tpu_torch import synthesizer_preprocess_alignments, vocoder_preprocess

    syn, ckpt = prep / "syn", prep / "taco.pt"
    synthesizer_preprocess_alignments.main([str(syn), "-m", str(ckpt), "--device", device])
    vocoder_preprocess.main([str(prep), "-i", str(syn), "-o", str(prep / "voc"), "-s",
                             str(ckpt), "--batch_size", "2", "--device", device])


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir, stages = Path(sys.argv[4]), sys.argv[5].split(",")
    torch.set_num_threads(1)
    from rtvc_tpu_torch.parallel import distributed

    if "prep" in stages:
        # the entry modules join the group the environment names
        os.environ.update({distributed.COORD_ENV: f"127.0.0.1:{port}",
                           distributed.NPROC_ENV: str(nproc), distributed.PID_ENV: str(pid)})
        run_passes(outdir / "prep")
        stages = [s for s in stages if s != "prep"]
    else:
        distributed.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu")
    dp = torch.distributed.group.WORLD

    def save(stage, model, **extra):
        torch.save({"state": {k: v.clone() for k, v in model.state_dict().items()}, **extra},
                   outdir / f"{stage}_{pid}.pt")

    if "enc" in stages:
        out = run_encoder(outdir / f"proc{pid}", rows(ENC["S"] * ENC["U"], pid, nproc), dp)
        save("enc", out["model"], losses=out["losses"],
             fetched=distributed.fetch(torch.full((2, 3), float(pid)), dp))
    for stage in ("taco", "fwd", "fast"):
        if stage in stages:
            out = run_synthesizer(stage, outdir / f"proc{pid}", rows(SYN_B, pid, nproc), dp)
            save(stage, out["model"], losses=out["losses"])
    if "voc" in stages:
        out = run_vocoder(outdir / f"proc{pid}", rows(VOC_B, pid, nproc), dp)
        save("voc", out["model"], losses=out["losses"], pruned=pruned_fraction(out["model"]))
        voc_model = out["model"]
    if "jax_enc" in stages or "jax_taco" in stages:
        inputs = torch.load(outdir / "jax_inputs.pt", weights_only=False)
        got = {}
        if "jax_enc" in stages:
            S, U = inputs["enc_shape"]
            got["enc"] = jax_encoder_step(inputs, rows(S * U, pid, nproc), dp)
        if "jax_taco" in stages:
            got["taco"] = jax_tacotron_step(inputs, rows(inputs["taco_batch"]["mels"].shape[0],
                                                         pid, nproc), dp)
        torch.save(got, outdir / f"jax_steps_{pid}.pt")
    torch.distributed.destroy_process_group()
    if "voc" in stages:
        # the group was the steps', not the model's: it trains alone now
        # each rank on rows of its own: a group left on the BatchNorms would
        # mix the two ranks' moments
        torch.save({"loss": vocoder_loss_alone(voc_model, VOC_B // (pid + 1))},
                   outdir / f"alone_{pid}.pt")
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
