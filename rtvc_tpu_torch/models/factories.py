"""Model factories (counterpart of ``rtvc_tpu/models/factories.py``) for the
ported models: the three synthesizers (Tacotron, ForwardTacotron,
FastPitch), the three WaveRNN variants (fatchord, geneing, runtimeracer)
with any of their heads, and the speaker encoder. Random
weights come from a ``torch.Generator`` seeded by ``seed``;
modules are built on the meta device and filled once, so no global RNG is
touched. Every factory builds on the card when ``device`` is left out and
raises without one; ``device="cpu"`` asks for the CPU. The distributions
follow the JAX package's initialisers, but the numbers differ: tests carry
JAX weights across through ``bridge``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Union

import torch
from torch import nn

from rtvc_tpu_torch.config import signal as _sig
from rtvc_tpu_torch.config import synthesizer as _syn_cfg
from rtvc_tpu_torch.config import vocoder as _voc_cfg
from rtvc_tpu_torch.config.encoder import EncoderDataParams, EncoderModelParams
from rtvc_tpu_torch.text.symbols import symbols
from rtvc_tpu_torch.models import layers
from rtvc_tpu_torch.models.fast_pitch import (
    FastPitch,
    FastPitchDims,
    MultiheadAttention,
    PositionalEncoding,
)
from rtvc_tpu_torch.models.forward_tacotron import BiLSTM, ForwardTacotron, ForwardTacotronDims
from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from rtvc_tpu_torch.models.tacotron import Tacotron, TacotronDims
from rtvc_tpu_torch.models.wavernn import WaveRNN, WaveRNNDims

MODEL_TYPE_TACOTRON = "tacotron"
MODEL_TYPE_FORWARD_TACOTRON = "forward-tacotron"
MODEL_TYPE_FASTPITCH = "fast-pitch"
SYN_MODEL_TYPES = (MODEL_TYPE_TACOTRON, MODEL_TYPE_FORWARD_TACOTRON, MODEL_TYPE_FASTPITCH)
MODEL_TYPE_FATCHORD = "fatchord-wavernn"
MODEL_TYPE_GENEING = "geneing-wavernn"
MODEL_TYPE_RUNTIMERACER = "runtimeracer-wavernn"
VOC_MODEL_TYPES = (MODEL_TYPE_FATCHORD, MODEL_TYPE_GENEING, MODEL_TYPE_RUNTIMERACER)

class SynModel(NamedTuple):
    model_type: str
    dims: Union[TacotronDims, ForwardTacotronDims, FastPitchDims]
    model: Union[Tacotron, ForwardTacotron, FastPitch]
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
        MODEL_TYPE_FORWARD_TACOTRON: _syn_cfg.forward_tacotron,
        MODEL_TYPE_FASTPITCH: _syn_cfg.fast_pitch,
        MODEL_TYPE_FATCHORD: _voc_cfg.wavernn_fatchord,
        MODEL_TYPE_GENEING: _voc_cfg.wavernn_geneing,
        MODEL_TYPE_RUNTIMERACER: _voc_cfg.wavernn_runtimeracer,
    }
    if model_type in defaults:
        return defaults[model_type]
    raise NotImplementedError("Invalid model of type '%s' provided. Aborting..." % model_type)


def config_from_dict(model_type: str, cfg_dict: Optional[dict]):
    """The hyper-parameter dataclass of a checkpoint's config dict (the
    counterpart of the JAX package's ``config_from_extras`` on
    ``extras['config']``), or the model type's defaults when the file
    carries none. Lists become tuples again (``tts_schedule``)."""
    cfg = default_config(model_type)  # raises for no such model
    if not cfg_dict:
        return cfg

    def detuple(v):
        return tuple(detuple(x) for x in v) if isinstance(v, list) else v

    return type(cfg)(**{k: detuple(v) for k, v in cfg_dict.items()})


def from_checkpoint(ckpt, kind: str, device=None, config=None):
    """The model of a checkpoint read by ``train.checkpoints.read_model``,
    built on ``device`` at the widths its config names and loaded with
    ``strict=True``: a SpeakerEncoder for ``kind`` "encoder", a SynModel or a
    VocModel. A file without a config takes ``config`` (the encoder's
    ``(model, data)`` pair), else the defaults; one without a model type is a
    Tacotron or a fatchord WaveRNN, as the reference's are. A FastPitch file
    without the speaker projections (the reference's FastPitch has none)
    takes them at zero, as the JAX package's importer does."""
    if kind == "encoder":
        cfgs = ((EncoderModelParams(**ckpt.config["model"]),
                 EncoderDataParams(**ckpt.config["data"])) if ckpt.config
                else config or (EncoderModelParams(), EncoderDataParams()))
        model = empty_on_device(lambda: SpeakerEncoder(*cfgs), device)
        model.load_state_dict(ckpt.state_dict, strict=True)
        return model.eval()
    synthesizer = kind == "synthesizer"
    model_type = ckpt.model_type or (MODEL_TYPE_TACOTRON if synthesizer else MODEL_TYPE_FATCHORD)
    cfg = config_from_dict(model_type, ckpt.config)
    state = ckpt.state_dict
    if synthesizer:
        dims = syn_dims(model_type, cfg)
        model = empty_on_device(lambda: _SYN_CLASSES[model_type](dims), device)
        if model_type == MODEL_TYPE_FASTPITCH:
            state = {**{k: torch.zeros_like(v, device="cpu")
                        for k, v in model.state_dict().items() if ".spk_proj." in f".{k}"},
                     **state}
    else:
        dims = wavernn_dims(model_type, cfg)
        model = empty_on_device(lambda: WaveRNN(dims), device)
    model.load_state_dict(state, strict=True)
    return (SynModel if synthesizer else VocModel)(model_type, dims, model.eval(), cfg)


def _uniform_(p: torch.Tensor, bound: float, g: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))


@torch.no_grad()
def _init_(module: nn.Module, g: torch.Generator) -> None:
    """Fill every parameter and buffer the way the JAX package initialises
    its layers (uniform ±1/√fan_in for linear, conv and recurrent weights;
    BatchNorm at identity; embeddings N(0, 1))."""
    for m in module.modules():
        if isinstance(m, (layers.LSTM, layers.GRU, BiLSTM, nn.GRUCell, nn.LSTMCell)):
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
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, MultiheadAttention):  # torch's: xavier in_proj, zero bias
            _uniform_(m.in_proj_weight, math.sqrt(6.0 / (2 * m.in_proj_weight.shape[1])), g)
            m.in_proj_bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g))
        elif isinstance(m, PositionalEncoding):
            m.scale.fill_(1.0)


@torch.no_grad()
def _xavier_(model: nn.Module, g: torch.Generator) -> None:
    """Xavier-uniform on every parameter of more than one dimension, over
    its last two axes, as the JAX package re-initialises Tacotron and
    ForwardTacotron."""
    for p in model.parameters():
        if p.ndim > 1:
            _uniform_(p, math.sqrt(6.0 / (p.shape[-1] + p.shape[-2])), g)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda``; RuntimeError when a card is asked
    for (``None`` or a CUDA device) and there is none.
    Nothing carries on on the CPU because it found no GPU; a caller that
    wants the CPU (the tests do) names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: rtvc_tpu_torch builds its models on the "
                           "card unless the caller passes device='cpu'")
    return device


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


def syn_dims(model_type: str, cfg):
    """The static dimensions of a synthesizer of this type and config."""
    if model_type == MODEL_TYPE_TACOTRON:
        return tacotron_dims(cfg)
    dims_cls = ForwardTacotronDims if model_type == MODEL_TYPE_FORWARD_TACOTRON else FastPitchDims
    return dims_cls.from_config(cfg, num_chars=len(symbols), n_mels=_sig.sp.num_mels,
                                spk=_sig.sv2tts.speaker_embedding_size)


def get_model_train_elements(model_type: str) -> list:
    """The dataset elements a synthesizer's training needs: the
    non-autoregressive ones also read the alignment pass's five files."""
    if model_type == MODEL_TYPE_TACOTRON:
        return ["mel", "embed"]
    if model_type in (MODEL_TYPE_FORWARD_TACOTRON, MODEL_TYPE_FASTPITCH):
        return ["mel", "embed", "duration", "attention", "alignment", "phoneme_pitch",
                "phoneme_energy"]
    raise NotImplementedError("Invalid model of type '%s' provided. Aborting..." % model_type)


def init_syn_model(model_type: str, seed: int = 0, override_hp=None,
                   device=None) -> SynModel:
    """A synthesizer of any of the three types with random weights:
    xavier-uniform on every >1-D tensor for Tacotron and ForwardTacotron,
    as the reference initialises them; FastPitch as the JAX package
    initialises it (torch's layer defaults)."""
    cfg = override_hp or default_config(model_type)
    if model_type not in SYN_MODEL_TYPES:
        raise NotImplementedError("Invalid model of type '%s' provided. Aborting..." % model_type)
    dims = syn_dims(model_type, cfg)
    return SynModel(model_type, dims, _INIT[model_type](dims, seed, device), cfg)


def init_tacotron(dims: TacotronDims, seed: int = 0, device=None) -> Tacotron:
    """A Tacotron of these dims with random weights."""
    model = empty_on_device(lambda: Tacotron(dims), device)
    g = torch.Generator().manual_seed(seed)
    _init_(model, g)
    _xavier_(model, g)
    return model.eval()


def init_forward_tacotron(dims: ForwardTacotronDims, seed: int = 0,
                          device=None) -> ForwardTacotron:
    """A ForwardTacotron of these dims with random weights."""
    model = empty_on_device(lambda: ForwardTacotron(dims), device)
    g = torch.Generator().manual_seed(seed)
    _init_(model, g)
    _xavier_(model, g)
    return model.eval()


def init_fast_pitch(dims: FastPitchDims, seed: int = 0, device=None) -> FastPitch:
    """A FastPitch of these dims with random weights."""
    model = empty_on_device(lambda: FastPitch(dims), device)
    _init_(model, torch.Generator().manual_seed(seed))
    return model.eval()


_SYN_CLASSES = {MODEL_TYPE_TACOTRON: Tacotron, MODEL_TYPE_FORWARD_TACOTRON: ForwardTacotron,
                MODEL_TYPE_FASTPITCH: FastPitch}
_INIT = {MODEL_TYPE_TACOTRON: init_tacotron, MODEL_TYPE_FORWARD_TACOTRON: init_forward_tacotron,
         MODEL_TYPE_FASTPITCH: init_fast_pitch}


def wavernn_dims(model_type: str, cfg) -> WaveRNNDims:
    sp = _sig.sp
    return WaveRNNDims.from_config(model_type, cfg, feat_dims=sp.num_mels,
                                   hop=sp.hop_size, sr=sp.sample_rate)


def init_voc_model(model_type: str, seed: int = 0,
                   override_hp: Optional[_voc_cfg.WaveRNNParams] = None,
                   device=None) -> VocModel:
    """A WaveRNN vocoder of any variant with random weights; the
    upsampler's smoothing convs start as moving averages. ``override_hp``
    replaces the variant's defaults (``mode="MOL"`` or ``"RAW"`` picks
    another head)."""
    if model_type not in VOC_MODEL_TYPES:
        raise NotImplementedError(
            "Invalid model of type '%s' provided. Aborting..." % model_type)
    cfg = override_hp or default_config(model_type)
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
