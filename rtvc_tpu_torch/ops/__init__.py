"""Ops: DSP on tensors (``audio``, ``stft``), numpy host DSP (``vad``,
``resample``, ``mel``, ``pitch``) and the kernel wrappers (``lstm_seq``, ``gru_seq``,
``tacotron_decode``, ``tacotron_train``, ``wavernn_generate``,
``mel_project``). Import the submodule you need."""
import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|: the measure a training kernel is held
    to against its plain version, which sums over T in another order."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
