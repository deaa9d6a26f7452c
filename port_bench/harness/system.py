"""The system under test, built from a configuration file and the
benchmark's seeded weights: the port's speaker encoder, synthesizer and
vocoder installed in its inference modules exactly as a checkpoint would
install them (modules built empty on the device, the weights loaded with
``strict=True``), and recorders on the program's two kernel entries whose
outputs the check reads (the decoder's frames before the postnet, the
sample loop's fold samples before the cross-fade)."""
from __future__ import annotations

from typing import Dict, List

import torch

from port_bench.harness import weights as seeded
from port_bench.reference import params

ENC, SYN, VOC = "encoder", "synthesizer", "vocoder"


def make_weights(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each model's weights from the seed: one generator a model, seeded from
    the run's seed and the model's place."""
    syn = config["synthesizer"]
    spec = (params.tacotron_spec if syn["type"] == "tacotron"
            else params.forward_tacotron_spec)(syn)
    if "stop_proj_bias" in syn:
        spec = [(n, s, ("c", syn["stop_proj_bias"]) if n == "decoder.stop_proj.bias" else i)
                for n, s, i in spec]
    return {ENC: seeded.make(params.encoder_spec(config["encoder"]), seed * 3 + 0, device),
            SYN: seeded.make(spec, seed * 3 + 1, device),
            VOC: seeded.make(params.wavernn_spec(config["vocoder"]), seed * 3 + 2, device)}


def install(config: dict, W: Dict[str, Dict[str, torch.Tensor]], device, voc_seed: int):
    """Install the three models in the port's inference modules → the
    port's ``Synthesizer``."""
    from rtvc_tpu_torch.config.encoder import EncoderModelParams
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.models import factories

    e = config["encoder"]
    encoder.load_state(W[ENC], device=device,
                       model_cfg=EncoderModelParams(model_hidden_size=e["hidden"],
                                                    model_embedding_size=e["embedding"],
                                                    model_num_layers=e["layers"]))
    syn = config["synthesizer"]
    mtype = syn["type"]
    base = factories.default_config(mtype)
    fields = {k: v for k, v in syn.items() if hasattr(base, k)}
    cfg = base.replace(**fields)
    dims = factories.syn_dims(mtype, cfg)
    model = factories.empty_on_device(lambda: factories._SYN_CLASSES[mtype](dims), device)
    model.load_state_dict(W[SYN], strict=True)
    synth = synthesizer.Synthesizer(device=device)
    synth.load_bundle(factories.SynModel(mtype, dims, model.eval(), cfg), r=syn.get("r", 2))
    v = config["vocoder"]
    vbase = factories.default_config(v["type"])
    vcfg = vbase.replace(**{k: (tuple(x) if isinstance(x, list) else x)
                            for k, x in v.items() if hasattr(vbase, k)})
    vdims = factories.wavernn_dims(v["type"], vcfg)
    vmodel = factories.empty_on_device(lambda: factories.WaveRNN(vdims), device)
    vmodel.load_state_dict(W[VOC], strict=True)
    vocoder.load_bundle(factories.VocModel(v["type"], vdims, vmodel.eval(), vcfg))
    vocoder.set_generation_options(compute_dtype="f32", target=None, overlap=None,
                                   stream_dtype="f32")
    vocoder.set_seed(voc_seed)
    return synth


def uninstall() -> None:
    from rtvc_tpu_torch.inference import encoder, vocoder

    encoder._model = None
    vocoder.load_bundle(None)
    unrecord()


class Recorder:
    """Keeps the return of the last call of a wrapped program function."""

    def __init__(self):
        self.last = None

    def wrap(self, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            self.last = out
            return out

        wrapped.__wrapped__ = fn
        return wrapped


_PATCHED: List[tuple] = []


def record() -> Dict[str, Recorder]:
    """Recorders on the synthesizer's decoder entry (K2) and the vocoder's
    sample-loop entry (K1)."""
    from rtvc_tpu_torch.inference import synthesizer as s
    from rtvc_tpu_torch.models import wavernn as w

    rec = {"decode": Recorder(), "samples": Recorder()}
    _PATCHED.append((s, "tacotron_decode", s.tacotron_decode))
    s.tacotron_decode = rec["decode"].wrap(s.tacotron_decode)
    _PATCHED.append((w, "wavernn_generate_core", w.wavernn_generate_core))
    w.wavernn_generate_core = rec["samples"].wrap(w.wavernn_generate_core)
    return rec


def unrecord() -> None:
    while _PATCHED:
        mod, name, fn = _PATCHED.pop()
        setattr(mod, name, fn)
