"""The port's FastPitch against the JAX package at narrow widths, on the
same weights (the port's seeded model carried to JAX through its
``import_torch_state``, the speaker projections, which that importer
zeroes, set from the port's): multi-head attention, the FFT block with a
key padding mask and exact lengths, the positional encoding, the series
predictors and the whole generate path, and the bridge both ways.
Tolerances: 1e-5 absolute for one module, 1e-4 for a whole generate's mel
(f32), and the durations equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config.synthesizer import FastPitchParams as JParams
from rtvc_tpu.models import fast_pitch as jfp
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.config.synthesizer import FastPitchParams
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import fast_pitch as tfp
from test_torch_forward_tacotron import _boundary_distance, _copy

ATOL = 1e-5
CFG = dict(embed_dims=16, n_heads=2, conv_dims=24, n_layers_enc=2, n_layers_dec=2,
           series_d_model=8, series_n_heads=2, series_layers=1, series_d_fft=12)
N_CHARS, N_MELS, SPK = 20, 6, 8


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(model, jd):
    """The JAX variables of the port's model: the importer's, with the
    speaker projections carried across too."""
    sd = _copy(model.state_dict())
    v = jfp.import_torch_state(sd, jd)
    for prefix in ("", "dur_pred.", "pitch_pred.", "energy_pred."):
        tree = v["params"][prefix[:-1]] if prefix else v["params"]
        tree["spk_proj"] = {k: jnp.asarray(sd[f"{prefix}spk_proj.{k}"].numpy())
                            for k in ("weight", "bias")}
    return v


@pytest.fixture(scope="module")
def fp():
    """The narrow model (non-trivial LayerNorms and positional scales), its
    JAX variables, two texts (12 and 16 characters in a 16 bucket) and
    speaker embeddings. As in ``test_torch_forward_tacotron``, the duration
    head's bias is chosen from a grid, on these weights, so that every
    prediction at speed 1 and 1.25 lies well away from the x.5 rounding
    boundaries."""
    jd = jfp.FastPitchDims.from_config(JParams(**CFG), N_CHARS, N_MELS, SPK)
    d = tfp.FastPitchDims.from_config(FastPitchParams(**CFG), N_CHARS, N_MELS, SPK)
    assert tuple(jd) == tuple(d)
    model = factories.init_fast_pitch(d, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    chars = np.where(np.arange(16)[None, :] < np.array([[12], [16]]),
                     rng.integers(1, N_CHARS, (2, 16)), 0).astype(np.int32)
    spk = rng.standard_normal((2, SPK)).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("scale"):
                p.copy_(p + 0.2 * torch.randn(p.shape, generator=g))
        model.dur_pred.lin.bias.zero_()
        x = torch.from_numpy(chars).long()
        raw = model.dur_pred(x, torch.from_numpy(spk), x == 0)[..., 0].numpy()
        bias = max(np.arange(2.0, 3.0, 0.01), key=lambda b: min(
            _boundary_distance(raw + b), _boundary_distance((raw + b) * 1.25)))
        model.dur_pred.lin.bias.fill_(float(bias))
    assert min(_boundary_distance(raw + bias), _boundary_distance((raw + bias) * 1.25)) > 1e-2
    return jd, d, _jax_variables(model, jd), model, chars, spk


def _np(t):
    return t.detach().numpy()


def _layer_params(v, path):
    tree = v["params"]
    for k in path:
        tree = tree[k]
    return tree


def test_positional_encoding_table():
    assert np.array_equal(tfp.positional_encoding_table(16, 50),
                          jfp.positional_encoding_table(16, 50))


def test_multihead_attention_with_key_padding(fp):
    jd, d, v, model, chars, spk = fp
    x = np.random.default_rng(2).standard_normal((2, 9, 16)).astype(np.float32)
    mask = np.arange(9)[None, :] >= np.array([[9], [5]])
    p = _layer_params(v, ("prenet", "layers_0", "self_attn"))
    ref = jfp.multihead_attention(p, jnp.asarray(x), 2, jnp.asarray(mask))
    with torch.no_grad():
        got = model.prenet.layers[0].self_attn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("masked,exact", [(False, False), (True, False), (True, True)])
def test_fft_block(fp, masked, exact):
    jd, d, v, model, chars, spk = fp
    x = np.random.default_rng(3).standard_normal((2, 11, 16)).astype(np.float32)
    mask = (np.arange(11)[None, :] >= np.array([[11], [7]])) if masked else None
    ref = jfp.fft_block(_layer_params(v, ("postnet", "layers_1")), jnp.asarray(x), 2, 3,
                        None if mask is None else jnp.asarray(mask), 0.0, None, False,
                        exact_lengths=exact)
    with torch.no_grad():
        got = model.postnet.layers[1](torch.from_numpy(x),
                                      None if mask is None else torch.from_numpy(mask), exact)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)
    if exact:
        assert (_np(got)[1, 7:] == 0).all()


@pytest.mark.parametrize("name", ["dur_pred", "pitch_pred", "energy_pred"])
def test_series_predictor(fp, name):
    jd, d, v, model, chars, spk = fp
    x = jnp.asarray(chars)
    ref = jfp._series_forward(v["params"][name], jd, x, jnp.asarray(spk), x == 0, 1.0, None,
                              False)
    t = torch.from_numpy(chars).long()
    with torch.no_grad():
        got = getattr(model, name)(t, torch.from_numpy(spk), t == 0)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


def _pitch_function(p):
    assert p.shape == (2, 1, 16)
    return p * 1.5 + 0.25


@pytest.fixture(scope="module")
def generates(fp):
    jd, d, v, model, chars, spk = fp
    return {key: jfp.fastpitch_generate(v, jd, jnp.asarray(chars), jnp.asarray(spk),
                                        jax.random.PRNGKey(0), alpha=alpha, pitch_function=fn)
            for key, alpha, fn in (("plain", 1.0, None),
                                   ("speed_pitch", 1.0 / 1.25, _pitch_function))}


@pytest.mark.parametrize("key,alpha,fn", [("plain", 1.0, None),
                                          ("speed_pitch", 1.0 / 1.25, _pitch_function)])
def test_generate_matches_jax(fp, generates, key, alpha, fn):
    jd, d, v, model, chars, spk = fp
    ref_mel, ref_durs = generates[key]
    mel, durs = tfp.fastpitch_generate(model, torch.from_numpy(chars).long(),
                                       torch.from_numpy(spk), alpha=alpha, pitch_function=fn)
    assert durs.dtype == np.int32 and np.array_equal(durs, ref_durs)
    lens = durs.sum(axis=1)
    assert mel.shape == (2, N_MELS, lens.max()) and len(set(lens)) == 2
    np.testing.assert_allclose(_np(mel), np.asarray(ref_mel)[:, :, :lens.max()], atol=1e-4)
    short = int(lens.argmin())
    assert (_np(mel)[short, :, lens.min():] == np.float32(d.padding_value)).all()


def test_speed_modifier_lengthens(fp, generates):
    assert generates["speed_pitch"][1].sum() > generates["plain"][1].sum()


def test_degenerate_durations_become_two(fp):
    jd, d, v, model, chars, spk = fp
    w, b = model.dur_pred.lin.weight.clone(), model.dur_pred.lin.bias.clone()
    try:
        with torch.no_grad():
            model.dur_pred.lin.weight.zero_()
            model.dur_pred.lin.bias.fill_(0.9)
        jv = _jax_variables(model, jd)
        mel, durs = tfp.fastpitch_generate(model, torch.from_numpy(chars).long(),
                                           torch.from_numpy(spk))
    finally:
        with torch.no_grad():
            model.dur_pred.lin.weight.copy_(w)
            model.dur_pred.lin.bias.copy_(b)
    ref_mel, ref_durs = jfp.fastpitch_generate(jv, jd, jnp.asarray(chars), jnp.asarray(spk),
                                               jax.random.PRNGKey(0))
    assert (durs == 2).all() and np.array_equal(durs, ref_durs)
    np.testing.assert_allclose(_np(mel), np.asarray(ref_mel)[:, :, :32], atol=1e-4)


def test_bridge_round_trips_through_the_jax_importer(fp):
    """JAX variables → the port's state bit for bit; the port's state
    through the JAX importer and back keeps every weight but the speaker
    projections, which that importer zeroes (the reference has none)."""
    jd, d, v, model, chars, spk = fp
    sd = model.state_dict()
    direct = bridge.fast_pitch_state(v)
    assert set(direct) == set(sd) and all(torch.equal(direct[k], sd[k]) for k in sd)
    back = bridge.fast_pitch_state(jfp.import_torch_state(_copy(sd), jd))
    assert set(back) == set(sd)
    for k in sd:
        want = torch.zeros_like(sd[k]) if "spk_proj." in k else sd[k]
        assert torch.equal(back[k], want), k
    factories.init_fast_pitch(d, seed=1, device="cpu").load_state_dict(back, strict=True)
