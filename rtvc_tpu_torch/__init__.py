"""rtvc_tpu_torch — the SV2TTS voice-clone path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``rtvc_tpu`` (JAX/Pallas), which stays the numerical reference;
this package imports nothing of it and keeps its own copies of the modules
it shares (``config``, ``text``, ``data``, ``utils.metrics``,
``utils.profiler``). The clone path runs speaker encoder → synthesizer
(Tacotron, ForwardTacotron or FastPitch) → WaveRNN (fatchord, geneing or
runtimeracer); the encoder, Tacotron and the WaveRNNs train here:

=========  ===========================================================
subpkg     role
=========  ===========================================================
ops        DSP on tensors (STFT, encoder and synthesizer mels, Griffin-Lim,
           mu-law, de-emphasis), numpy host DSP (VAD, resample, mel
           filterbank), and the kernel wrappers ``lstm_seq`` (K3),
           ``gru_seq`` (K4), ``tacotron_decode`` (K2), ``tacotron_train``
           (K5), ``wavernn_generate`` (K1), ``mel_project`` (K6)
csrc       the CUDA C++ sources of those kernels (built by ``_build``)
models     nn.Modules under the reference's torch state-dict names
inference  encoder / synthesizer / vocoder public API
train      GE2E encoder, Tacotron and WaveRNN training steps, trainers,
           checkpoints (entry points ``python -m rtvc_tpu_torch.encoder_train``,
           ``.synthesizer_train`` and ``.vocoder_train``)
config     typed hyper-parameters (the JAX package's, copied)
text       symbols, cleaners, number expansion (copied)
data       numpy datasets and samplers of the three trainers (copied)
bridge     JAX variables → state_dicts of this package's modules
=========  ===========================================================

Each kernel wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch twin for CPU tensors; nothing selects a backend otherwise. Models
are built on the card unless the caller names another device.

The JAX reference computes in float32, so TF32 is switched off for matrix
products and cuDNN convolutions when this package is imported. Under the
bf16 training policy (``ops.precision``) the bf16 GEMMs accumulate in f32,
as the policy states: cuBLAS's reduced-precision reduction is switched off
too.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
