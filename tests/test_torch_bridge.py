"""The weight bridge: JAX variables → the port's state_dicts, and back
through the JAX package's own ``import_torch_state``; plus the port's
JAX-free import."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from rtvc_tpu.config.encoder import EncoderModelParams as JEncoderModelParams
from rtvc_tpu_torch.config.encoder import EncoderModelParams
from rtvc_tpu.models import speaker_encoder as jspk
from rtvc_tpu.models import tacotron as jtaco
from rtvc_tpu.models import wavernn as jwav
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from rtvc_tpu_torch.models.tacotron import Tacotron, TacotronDims
from rtvc_tpu_torch.models.wavernn import WaveRNN, WaveRNNDims

REPO = Path(__file__).resolve().parents[1]

TACO_DIMS = dict(
    num_chars=40, n_mels=16, fft_bins=16, speaker_embedding_size=24,
    embed_dims=16, encoder_dims=8, decoder_dims=16, postnet_dims=8,
    encoder_K=2, postnet_K=2, num_highways=2, lstm_dims=16,
    max_r=4, dropout=0.5, stop_threshold=-3.4,
)
VOC_DIMS = dict(
    variant="runtimeracer-wavernn", mode="RAW", rnn_dims=16, fc_dims=16, bits=6,
    pad=2, upsample_factors=(2, 2, 5), feat_dims=10, compute_dims=8,
    res_out_dims=16, res_blocks=1, hop_length=20, sample_rate=1000,
)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_speaker_encoder_round_trip():
    cfg = EncoderModelParams(model_hidden_size=16, model_embedding_size=12,
                             model_num_layers=3)
    v = jspk.SpeakerEncoder(model=JEncoderModelParams(**cfg.asdict())).init(jax.random.PRNGKey(0),
                                            np.zeros((1, 8, 40), np.float32))
    sd = bridge.speaker_encoder_state(v)
    back = jspk.import_torch_state(sd)
    _assert_trees_equal(back["params"], v["params"])
    np.testing.assert_array_equal(np.asarray(back["similarity"]["similarity_weight"]), [10.0])
    SpeakerEncoder(cfg).load_state_dict(sd, strict=True)


def test_tacotron_round_trip():
    jd = jtaco.TacotronDims(**TACO_DIMS)
    # jitted: the eager flax init takes several times longer on the CPU
    v = jax.jit(jtaco.init_tacotron, static_argnums=1)(jax.random.PRNGKey(0), jd)
    sd = bridge.tacotron_state(v)
    _assert_trees_equal(jtaco.import_torch_state(sd, jd), v)
    Tacotron(TacotronDims(**TACO_DIMS)).load_state_dict(sd, strict=True)


def test_wavernn_round_trip():
    jd = jwav.WaveRNNDims(**VOC_DIMS)
    v = jwav.init_wavernn(jax.random.PRNGKey(0), jd)
    sd = bridge.wavernn_state(v)
    _assert_trees_equal(jwav.import_torch_state(sd, jd), v)
    WaveRNN(WaveRNNDims(**VOC_DIMS)).load_state_dict(sd, strict=True)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import rtvc_tpu_torch, rtvc_tpu_torch.bridge\n"
        "from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder\n"
        "from rtvc_tpu_torch.models import factories\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'flax' not in sys.modules and 'optax' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("model_type", ["forward-tacotron", "fast-pitch"])
def test_later_synthesizers_raise(model_type):
    """ForwardTacotron and FastPitch are built (their parity with the JAX
    package is in their own test files) and trained: their training reads
    the JAX package's seven dataset elements (the alignment pass's five
    beside the mel and the embedding); an unknown type still raises."""
    from rtvc_tpu.models import factories as jfactories
    from rtvc_tpu_torch.models import factories

    bundle = factories.init_syn_model(model_type, device="cpu")
    assert bundle.model_type == model_type and bundle.dims.n_mels == 80
    assert bundle.config == factories.default_config(model_type)
    assert factories.get_model_train_elements(model_type) == \
        jfactories.get_model_train_elements(model_type)
    assert len(factories.get_model_train_elements(model_type)) == 7
    with pytest.raises(NotImplementedError, match="Invalid model"):
        factories.get_model_train_elements(model_type + "-2")
