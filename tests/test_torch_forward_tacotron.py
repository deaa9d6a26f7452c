"""The port's ForwardTacotron against the JAX package at narrow widths, on
the same weights (the port's seeded model, carried to JAX through its
``import_torch_state``): the CBHG's forward variant with and without
lengths, the length regulator, the series predictors, the packed BiLSTM
(K3's plain version here; the JAX side scans at these widths) and the whole
generate path. Tolerances: 1e-5 absolute for one module, 1e-4 for a whole
generate's mel (f32), and the durations equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.config.synthesizer import ForwardTacotronParams as JParams
from rtvc_tpu.models import forward_tacotron as jft
from rtvc_tpu.models import layers as jl
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.config.synthesizer import ForwardTacotronParams
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import forward_tacotron as tft
from rtvc_tpu_torch.models import layers as tl

ATOL = 1e-5
CFG = dict(embed_dims=16, series_embed_dims=8, duration_conv_dims=12, duration_rnn_dims=8,
           pitch_conv_dims=12, pitch_rnn_dims=8, energy_conv_dims=12, energy_rnn_dims=8,
           prenet_dims=16, prenet_k=3, prenet_num_highways=2, rnn_dims=16, postnet_dims=12,
           postnet_k=3, postnet_num_highways=2)
N_CHARS, N_MELS, SPK = 20, 6, 8


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread for the whole module: these models are small, and
    beside the other test workers more OpenMP threads only wait on each
    other. Module-scoped, so that it is set before the module-scoped
    fixtures compute their reference data: the duration head's bias is
    picked from predictions whose last bits follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(sd):
    """A state dict's tensors copied: the JAX importer's arrays may share a
    CPU tensor's memory, and the model's weights change in one test."""
    return {k: v.clone() for k, v in sd.items()}


def _boundary_distance(dur: np.ndarray) -> float:
    """The least distance of any prediction from a rounding boundary x.5."""
    return float(np.abs((dur - 0.5) - np.round(dur - 0.5)).min())


@pytest.fixture(scope="module")
def ft():
    """The narrow model with non-trivial BatchNorm statistics, its JAX
    variables, two texts (12 and 16 characters in a 16 bucket, 0-padded)
    and speaker embeddings. The duration head's bias is chosen (from a
    grid, on these weights) so that every prediction, at speed 1 and at
    speed 1.25, lies well away from the x.5 rounding boundaries: a
    prediction within float noise of one could round either way in the two
    packages."""
    jd = jft.ForwardTacotronDims.from_config(JParams(**CFG), N_CHARS, N_MELS, SPK)
    d = tft.ForwardTacotronDims.from_config(ForwardTacotronParams(**CFG), N_CHARS, N_MELS, SPK)
    assert tuple(jd) == tuple(d)
    model = factories.init_forward_tacotron(d, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    chars = np.where(np.arange(16)[None, :] < np.array([[12], [16]]),
                     rng.integers(1, N_CHARS, (2, 16)), 0).astype(np.int32)
    spk = rng.standard_normal((2, SPK)).astype(np.float32)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5) if name.endswith("var") else buf.normal_(0, 0.2)
        model.dur_pred.lin.bias.zero_()
        raw = model.dur_pred(torch.from_numpy(chars).long(), torch.from_numpy(spk))[..., 0]
        raw = raw.numpy()
        bias = max(np.arange(2.0, 3.0, 0.01), key=lambda b: min(
            _boundary_distance(raw + b), _boundary_distance((raw + b) * 1.25)))
        model.dur_pred.lin.bias.fill_(float(bias))
    assert min(_boundary_distance(raw + bias), _boundary_distance((raw + bias) * 1.25)) > 1e-2
    v = jft.import_torch_state(_copy(model.state_dict()), jd)
    return jd, d, v, model, chars, spk


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name,lengths", [("prenet", None), ("postnet", None),
                                          ("postnet", [20, 13])])
def test_cbhg_forward_variant(ft, name, lengths):
    jd, d, v, model, chars, spk = ft
    cbhg = getattr(model, name)
    c_in = cbhg.conv1d_bank[0].conv.in_channels
    x = np.random.default_rng(3).standard_normal((2, 20, c_in)).astype(np.float32)
    k, ch = (d.prenet_k, d.prenet_dims) if name == "prenet" else (d.postnet_k, d.postnet_dims)
    jmod = jl.CBHG(K=k, in_channels=c_in, channels=ch, proj_channels=(ch, c_in),
                   num_highways=2, forward_variant=True)
    ref = jmod.apply({"params": v["params"][name], "batch_stats": v["batch_stats"][name]},
                     jnp.asarray(x), train=False,
                     lengths=None if lengths is None else jnp.asarray(lengths))
    with torch.no_grad():
        got = cbhg(torch.from_numpy(x), None if lengths is None else torch.tensor(lengths))
    assert got.shape == (2, 20, 2 * ch)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


def test_cbhg_forward_variant_has_its_own_layout():
    """Hidden = channels, pre_highway always, dropout in training only,
    drawn from the generator it is given."""
    cbhg = tl.CBHG(3, 6, 8, (8, 6), 1, forward_variant=True, dropout=0.5)
    assert cbhg.rnn.hidden_size == 8 and cbhg.pre_highway is not None
    taco = tl.CBHG(3, 8, 8, (8, 8), 1)
    assert taco.rnn.hidden_size == 4 and taco.pre_highway is None and taco.dropout == 0.0
    x = torch.randn(2, 9, 6, generator=torch.Generator().manual_seed(0))
    for p in cbhg.parameters():
        torch.nn.init.uniform_(p, -0.3, 0.3)
    for b in cbhg.buffers():
        b.fill_(1.0)
    with torch.no_grad():
        assert torch.equal(cbhg(x), cbhg(x))
        train = [cbhg(x, new_stats={}, generator=torch.Generator().manual_seed(s))
                 for s in (1, 1, 2)]
    assert torch.equal(train[0], train[1]) and not torch.equal(train[0], train[2])


@pytest.mark.parametrize("max_len", [9, 14])
def test_length_regulator(max_len):
    x = np.random.default_rng(4).standard_normal((2, 5, 3)).astype(np.float32)
    durs = np.array([[2, 0, 3, 1, 3], [0, 0, 4, 1, 0]], np.int32)
    ref = jl.LengthRegulator().apply({"params": {}}, jnp.asarray(x), jnp.asarray(durs), max_len)
    got = tl.length_regulate(torch.from_numpy(x), torch.from_numpy(durs), max_len)
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("name,conv,rnn", [("dur_pred", "duration_conv_dims", "duration_rnn_dims"),
                                           ("pitch_pred", "pitch_conv_dims", "pitch_rnn_dims"),
                                           ("energy_pred", "energy_conv_dims",
                                            "energy_rnn_dims")])
def test_series_predictor(ft, name, conv, rnn):
    jd, d, v, model, chars, spk = ft
    ref, _ = jft.series_predictor(jd, name, getattr(jd, conv), getattr(jd, rnn), 0.0,
                                  v["params"], v["batch_stats"], jnp.asarray(chars),
                                  jnp.asarray(spk))
    with torch.no_grad():
        got = getattr(model, name)(torch.from_numpy(chars).long(), torch.from_numpy(spk))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


def test_bilstm_packed_unequal_lengths(ft):
    jd, d, v, model, chars, spk = ft
    x = np.random.default_rng(5).standard_normal((2, 11, 2 * d.prenet_dims + SPK))
    x = x.astype(np.float32)
    lens = np.array([11, 6])
    ref = jft.bilstm_packed(v["params"]["lstm"], jnp.asarray(x), jnp.asarray(lens),
                            d.padding_value)
    with torch.no_grad():
        got = tft.bilstm_packed(model.lstm, torch.from_numpy(x), torch.from_numpy(lens),
                                d.padding_value)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)
    assert (_np(got)[1, 6:] == np.float32(d.padding_value)).all()


def _pitch_function(p):
    assert p.shape == (2, 1, 16)
    return p * 1.5 + 0.25


@pytest.fixture(scope="module")
def generates(ft):
    """JAX ``forward_generate`` at speed 1, and at speed 1.25 with a pitch
    function, on the shared weights (one jit of each half for both)."""
    jd, d, v, model, chars, spk = ft
    out = {}
    for key, alpha, fn in (("plain", 1.0, None), ("speed_pitch", 1.0 / 1.25, _pitch_function)):
        out[key] = jft.forward_generate(v, jd, jnp.asarray(chars), jnp.asarray(spk),
                                        jax.random.PRNGKey(0), alpha=alpha, pitch_function=fn)
    return out


@pytest.mark.parametrize("key,alpha,fn", [("plain", 1.0, None),
                                          ("speed_pitch", 1.0 / 1.25, _pitch_function)])
def test_generate_matches_jax(ft, generates, key, alpha, fn):
    jd, d, v, model, chars, spk = ft
    ref_mel, ref_durs = generates[key]
    mel, durs = tft.forward_generate(model, torch.from_numpy(chars).long(),
                                     torch.from_numpy(spk), alpha=alpha, pitch_function=fn)
    assert durs.dtype == np.int32 and np.array_equal(durs, ref_durs)
    lens = durs.sum(axis=1)
    assert mel.shape == (2, N_MELS, lens.max()) and len(set(lens)) == 2
    np.testing.assert_allclose(_np(mel), np.asarray(ref_mel)[:, :, :lens.max()], atol=1e-4)


def test_speed_modifier_lengthens(ft, generates):
    assert generates["speed_pitch"][1].sum() > generates["plain"][1].sum()


def test_degenerate_durations_become_two(ft):
    """Predictions whose truncations sum to 0 (here 0.9 everywhere, which
    rounding alone would make 1) give every character 2 frames, in both."""
    jd, d, v, model, chars, spk = ft
    w, b = model.dur_pred.lin.weight.clone(), model.dur_pred.lin.bias.clone()
    try:
        with torch.no_grad():
            model.dur_pred.lin.weight.zero_()
            model.dur_pred.lin.bias.fill_(0.9)
        jv = jft.import_torch_state(_copy(model.state_dict()), jd)
        mel, durs = tft.forward_generate(model, torch.from_numpy(chars).long(),
                                         torch.from_numpy(spk))
    finally:
        with torch.no_grad():
            model.dur_pred.lin.weight.copy_(w)
            model.dur_pred.lin.bias.copy_(b)
    ref_mel, ref_durs = jft.forward_generate(jv, jd, jnp.asarray(chars), jnp.asarray(spk),
                                             jax.random.PRNGKey(0))
    assert (durs == 2).all() and np.array_equal(durs, ref_durs)
    np.testing.assert_allclose(_np(mel), np.asarray(ref_mel)[:, :, :32], atol=1e-4)


def test_bridge_round_trips_through_the_jax_importer(ft):
    jd, d, v, model, chars, spk = ft
    sd = model.state_dict()
    back = bridge.forward_tacotron_state(jft.import_torch_state(sd, jd))
    assert list(back) == list(sd) or set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    fresh = factories.init_forward_tacotron(d, seed=1, device="cpu")
    fresh.load_state_dict(back, strict=True)
    params_only = bridge.forward_tacotron_state({"params": v["params"]})
    assert set(params_only) == {k for k, _ in model.named_parameters()}
