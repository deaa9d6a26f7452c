"""Model factories (counterpart of ``rtvc_tpu/models/factories.py``) for the
ported slice: Tacotron and the runtimeracer WaveRNN, plus the speaker
encoder. Random weights come from a ``torch.Generator`` seeded by ``seed``;
modules are built on the meta device and filled once, so no global RNG is
touched. Every factory builds on the card when ``device`` is left out and
raises without one; ``device="cpu"`` asks for the CPU. The distributions
follow the JAX package's initialisers, but the numbers differ: tests carry
JAX weights across through ``bridge``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from rtvc_tpu_torch.config import signal as _sig
from rtvc_tpu_torch.config import synthesizer as _syn_cfg
from rtvc_tpu_torch.config import vocoder as _voc_cfg
from rtvc_tpu_torch.config.encoder import EncoderDataParams, EncoderModelParams
from rtvc_tpu_torch.text.symbols import symbols
from rtvc_tpu_torch.models import layers
from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from rtvc_tpu_torch.models.tacotron import Tacotron, TacotronDims
from rtvc_tpu_torch.models.wavernn import WaveRNN, WaveRNNDims

MODEL_TYPE_TACOTRON = "tacotron"
MODEL_TYPE_FORWARD_TACOTRON = "forward-tacotron"
MODEL_TYPE_FASTPITCH = "fast-pitch"
SYN_MODEL_TYPES = (MODEL_TYPE_TACOTRON, MODEL_TYPE_FORWARD_TACOTRON, MODEL_TYPE_FASTPITCH)
MODEL_TYPE_RUNTIMERACER = "runtimeracer-wavernn"

_LATER = ("{} is not ported to rtvc_tpu_torch yet: the non-autoregressive "
          "synthesizers and the other WaveRNN variants are later slices")


class SynModel(NamedTuple):
    model_type: str
    dims: TacotronDims
    model: Tacotron
    config: Any


class VocModel(NamedTuple):
    model_type: str
    dims: WaveRNNDims
    model: WaveRNN
    config: _voc_cfg.WaveRNNParams


def default_config(model_type: str):
    """The default hyper-parameters of a model type."""
    defaults = {
        MODEL_TYPE_TACOTRON: _syn_cfg.tacotron,
        MODEL_TYPE_RUNTIMERACER: _voc_cfg.wavernn_runtimeracer,
    }
    if model_type not in defaults:
        raise NotImplementedError(_LATER.format(model_type))
    return defaults[model_type]


def _uniform_(p: torch.Tensor, bound: float, g: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))


@torch.no_grad()
def _init_(module: nn.Module, g: torch.Generator) -> None:
    """Fill every parameter and buffer the way the JAX package initialises
    its layers (uniform ±1/√fan_in for linear, conv and recurrent weights;
    BatchNorm at identity; embeddings N(0, 1))."""
    for m in module.modules():
        if isinstance(m, (layers.LSTM, layers.GRU, nn.GRUCell, nn.LSTMCell)):
            for p in m.parameters(recurse=False):
                _uniform_(p, 1.0 / math.sqrt(m.hidden_size), g)
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            for p in m.parameters(recurse=False):
                _uniform_(p, 1.0 / math.sqrt(fan_in), g)
        elif isinstance(m, layers.BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            m.running_mean.fill_(0.0)
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g))


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda``, and RuntimeError when there is none.
    Nothing carries on on the CPU because it found no GPU; a caller that
    wants the CPU (the tests do) names it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: rtvc_tpu_torch builds its models on the "
                           "card unless the caller passes device='cpu'")
    return torch.device("cuda")


def empty_on_device(module_fn, device=None) -> nn.Module:
    """Build a module on the meta device, then allocate it (uninitialised)
    on ``device`` (``None``: the card, see :func:`resolve_device`)."""
    device = resolve_device(device)
    with torch.device("meta"):
        module = module_fn()
    return module.to_empty(device=device)


def init_encoder_model(seed: int = 0, device=None,
                       model_cfg: EncoderModelParams = EncoderModelParams(),
                       data_cfg: EncoderDataParams = EncoderDataParams()
                       ) -> SpeakerEncoder:
    """A speaker encoder with random weights."""
    model = empty_on_device(lambda: SpeakerEncoder(model_cfg, data_cfg), device)
    _init_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.similarity_weight.fill_(10.0)
        model.similarity_bias.fill_(-5.0)
    return model.eval()


def tacotron_dims(cfg) -> TacotronDims:
    sp = _sig.sp
    return TacotronDims.from_config(cfg, num_chars=len(symbols), n_mels=sp.num_mels,
                                    fft_bins=sp.num_mels,
                                    spk=_sig.sv2tts.speaker_embedding_size)


def get_model_train_elements(model_type: str) -> list:
    """The dataset elements a synthesizer's training needs."""
    if model_type == MODEL_TYPE_TACOTRON:
        return ["mel", "embed"]
    raise NotImplementedError(_LATER.format(model_type))


def init_syn_model(model_type: str, seed: int = 0, override_hp=None,
                   device=None) -> SynModel:
    """A synthesizer with random weights (xavier-uniform on every >1-D
    tensor, as the reference initialises Tacotron)."""
    cfg = override_hp or default_config(model_type)
    if model_type != MODEL_TYPE_TACOTRON:
        raise NotImplementedError(_LATER.format(model_type))
    dims = tacotron_dims(cfg)
    return SynModel(model_type, dims, init_tacotron(dims, seed, device), cfg)


def init_tacotron(dims: TacotronDims, seed: int = 0, device=None) -> Tacotron:
    """A Tacotron of these dims with random weights."""
    model = empty_on_device(lambda: Tacotron(dims), device)
    g = torch.Generator().manual_seed(seed)
    _init_(model, g)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim > 1:
                limit = math.sqrt(6.0 / (p.shape[-1] + p.shape[-2]))
                _uniform_(p, limit, g)
    return model.eval()


def wavernn_dims(model_type: str, cfg) -> WaveRNNDims:
    sp = _sig.sp
    return WaveRNNDims.from_config(model_type, cfg, feat_dims=sp.num_mels,
                                   hop=sp.hop_size, sr=sp.sample_rate)


def init_voc_model(model_type: str, seed: int = 0,
                   override_hp: Optional[_voc_cfg.WaveRNNParams] = None,
                   device=None) -> VocModel:
    """A WaveRNN vocoder with random weights; the upsampler's smoothing
    convs start as moving averages."""
    cfg = override_hp or default_config(model_type)
    if model_type != MODEL_TYPE_RUNTIMERACER:
        raise NotImplementedError(_LATER.format(model_type))
    dims = wavernn_dims(model_type, cfg)
    return VocModel(model_type, dims, init_wavernn(dims, seed, device), cfg)


def init_wavernn(dims: WaveRNNDims, seed: int = 0, device=None) -> WaveRNN:
    """A WaveRNN of these dims with random weights."""
    model = empty_on_device(lambda: WaveRNN(dims), device)
    _init_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for i, s in enumerate(dims.upsample_factors):
            model.upsample.up_layers[2 * i + 1].weight.fill_(1.0 / (2 * s + 1))
    return model.eval()
