"""Port layers against the flax modules of ``rtvc_tpu/models/layers.py`` on
the same weights and inputs (f32 on the CPU; tolerance 1e-5 absolute, the
float32 summation-order noise at these widths)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.models import layers as jl
from rtvc_tpu.models.tacotron import _prenet_nodrop
from rtvc_tpu_torch import bridge
from rtvc_tpu_torch.models import layers as tl

ATOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.from_numpy(np.array(v, np.float32))
    return out


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _random_stats(stats, seed=1):
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) if isinstance(v, dict) else (
                rng.uniform(0.5, 1.5, np.shape(v)) if k == "running_var"
                else rng.normal(0, 0.3, np.shape(v))).astype(np.float32)
                for k, v in t.items()}
        return t

    return walk(stats)


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out), atol=atol)


def test_linear():
    x = _x(2, 5, 6)
    v = jl.Linear(7).init(jax.random.PRNGKey(0), x)
    m = tl.Linear(6, 7)
    m.load_state_dict(_flat(v["params"]))
    _close(m(torch.from_numpy(x)), jl.Linear(7).apply(v, x))


@pytest.mark.parametrize("k,padding", [(4, 2), (5, 2), (31, 15)])
def test_conv1d(k, padding):
    x = _x(2, 9, 3)
    mod = jl.Conv1d(5, k, padding=padding)
    v = mod.init(jax.random.PRNGKey(0), x)
    m = tl.Conv1d(3, 5, k, padding=padding)
    m.load_state_dict(_flat(v["params"]))
    _close(m(torch.from_numpy(x)), mod.apply(v, x))


def test_batchnorm_inference():
    x = _x(2, 7, 6)
    mod = jl.BatchNorm1d(6)
    v = mod.init(jax.random.PRNGKey(0), x)
    v = {"params": v["params"], "batch_stats": _random_stats(v["batch_stats"])}
    m = tl.BatchNorm1d(6)
    m.load_state_dict({**_flat(v["params"]), **_flat(v["batch_stats"])})
    _close(m(torch.from_numpy(x)), mod.apply(v, x, train=False))


def test_prenet_without_dropout():
    x = _x(3, 10)
    mod = jl.PreNet(12, 8)
    v = mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x)
    m = tl.PreNet(10, 12, 8)
    m.load_state_dict(_flat(v["params"]))
    _close(m(torch.from_numpy(x), dropout=False),
           _prenet_nodrop(v["params"], jnp.asarray(x), jnp.float32))


def test_prenet_dropout_is_seeded():
    m = tl.PreNet(10, 12, 8)
    torch.nn.init.uniform_(m.fc1.weight, 0.1, 0.2)
    torch.nn.init.uniform_(m.fc2.weight, 0.1, 0.2)
    x = torch.ones(4, 10)

    def run(seed):
        return m(x, torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert (run(3) == 0).float().mean() > 0.2


def test_highway():
    x = _x(2, 5, 6)
    mod = jl.HighwayNetwork(6)
    v = mod.init(jax.random.PRNGKey(0), x)
    m = tl.HighwayNetwork(6)
    m.load_state_dict(_flat(v["params"]))
    _close(m(torch.from_numpy(x)), mod.apply(v, x))


@pytest.mark.parametrize("bidirectional,masked", [(False, False), (True, False),
                                                  (True, True)])
def test_gru(bidirectional, masked):
    x = _x(3, 9, 5)
    lengths = np.array([9, 4, 6], np.int32) if masked else None
    mod = jl.GRU(6, bidirectional=bidirectional)
    v = mod.init(jax.random.PRNGKey(0), x)
    m = tl.GRU(5, 6, bidirectional=bidirectional)
    m.load_state_dict(_flat(v["params"]))
    y, h = m(torch.from_numpy(x),
             lengths=None if lengths is None else torch.from_numpy(lengths))
    jy, jh = mod.apply(v, x, lengths=None if lengths is None else jnp.asarray(lengths))
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("in_channels,proj,masked", [
    (8, (8, 8), False), (8, (8, 8), True), (6, (8, 6), False), (6, (8, 6), True),
])
def test_cbhg(in_channels, proj, masked):
    x = _x(2, 11, in_channels)
    lengths = np.array([11, 7], np.int32) if masked else None
    mod = jl.CBHG(K=3, in_channels=in_channels, channels=8, proj_channels=proj,
                  num_highways=2)
    v = mod.init(jax.random.PRNGKey(0), x)
    stats = _random_stats(v["batch_stats"])
    sd = {}
    bridge._cbhg(sd, "", v["params"], stats)
    m = tl.CBHG(3, in_channels, 8, proj, 2)
    m.load_state_dict(sd, strict=True)
    out = m(torch.from_numpy(x),
            lengths=None if lengths is None else torch.from_numpy(lengths))
    ref = mod.apply({"params": v["params"], "batch_stats": stats}, x, train=False,
                    lengths=None if lengths is None else jnp.asarray(lengths))
    _close(out, ref)
