"""The bf16 training policy's pieces against the JAX package, on the CPU:

  * ``ops.precision``: ``resolve`` (``auto`` is f32 here, as the JAX package
    resolves it off a TPU), ``cast_floats`` over tensors and dicts, and
    ``cast_parameters``, whose forward runs on bf16 casts while the
    gradients reach the f32 parameters in f32; the port's ``Linear`` and
    ``Conv1d`` round a product before adding its bias, equal in bits to the
    JAX package's layers under its policy;
  * K3's and K4's plain versions on bf16 streams (f32 state) through
    ``LSTMSeqFn`` and ``GRUSeqFn``, forward and backward, against the JAX
    package's ``lstm_seq_fused`` / ``gru_seq_fused`` in interpret mode on the
    same bf16 inputs at B 2-3 x T 8 x H 128: bf16 outputs within
    ``torch.testing``'s bf16 defaults (rtol 1.6e-2, atol 1e-5; K3's
    ``dW_hh`` with atol 1e-3 of its largest entry, see there), the f32
    states and ``dh0`` / ``dc0`` within 1e-4;
  * K5 cast around its launch (``taco_decoder_train`` on bf16 inputs and
    the f32 weights ``prepare_train_weights`` gives): the forward against
    the Pallas kernel in interpret mode on the same bf16 inputs, and the
    backward against ``jax.vjp`` of the JAX reference scan behind an f32
    cast of those inputs (the JAX kernel's own cast-around), at the f32
    tolerances of ``test_torch_taco_train_kernel``; the cotangents come back
    in bf16, which adds one bf16 rounding (2^-8 of each entry) to their
    tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.ops import precision as jprecision
from rtvc_tpu.ops.pallas import tacotron_train_kernel as jk
from rtvc_tpu.ops.pallas.gru_train_kernel import gru_seq_fused
from rtvc_tpu.ops.pallas.lstm_train_kernel import lstm_seq_fused
from rtvc_tpu_torch.ops import gru_seq as k4
from rtvc_tpu_torch.ops import lstm_seq as k3
from rtvc_tpu_torch.ops import precision
from rtvc_tpu_torch.ops import tacotron_train as tk
from test_torch_taco_train_kernel import cotangents, jax_inputs, jax_weights, make_case, scan_chain

BF16 = dict(rtol=1.6e-2, atol=1e-5)  # torch.testing's defaults for bf16
BF16_ULP = 2.0 ** -8


def _bf16(a):
    """A numpy array rounded to bf16, as (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


@pytest.mark.parametrize("name,want", [("auto", torch.float32), (None, torch.float32),
                                       ("f32", torch.float32), ("float32", torch.float32),
                                       ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
                                       (torch.bfloat16, torch.bfloat16)])
def test_resolve_matches_the_jax_package_off_a_tpu(name, want):
    assert precision.resolve(name) == want
    if isinstance(name, str) or name is None:
        jwant = jnp.bfloat16 if want == torch.bfloat16 else jnp.float32
        assert jprecision.resolve(name) == jwant


@pytest.mark.parametrize("name", ["f16", "fp8", torch.float16])
def test_resolve_refuses_unknown_names(name):
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        precision.resolve(name)


def test_cast_floats_casts_float_leaves_only():
    tree = {"mels": torch.ones(2, 3), "chars": torch.ones(2, dtype=torch.int64),
            "mask": torch.ones(2, dtype=torch.bool),
            "nested": {"pitch": torch.zeros(1, dtype=torch.float64), "n": 3}}
    out = precision.cast_floats(tree, torch.bfloat16)
    assert out["mels"].dtype == torch.bfloat16 and out["chars"].dtype == torch.int64
    assert out["mask"].dtype == torch.bool
    assert out["nested"]["pitch"].dtype == torch.bfloat16 and out["nested"]["n"] == 3
    assert tree["mels"].dtype == torch.float32  # the input is not changed
    assert precision.cast_floats(torch.ones(2), torch.bfloat16).dtype == torch.bfloat16


def test_cast_parameters_gives_f32_masters_f32_gradients():
    torch.manual_seed(0)
    lin = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.BatchNorm1d(4))
    x = torch.randn(5, 8)
    masters = [p for p in lin.parameters()]
    with precision.policy(lin, torch.bfloat16):
        assert precision.matmul_dtype() == torch.bfloat16
        assert {p.dtype for p in lin.parameters()} == {torch.bfloat16}
        assert lin[1].running_mean.dtype == torch.float32  # buffers stay f32
        y = lin[0](precision.cast_floats(x, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and precision.matmul_dtype() == torch.float32
    assert [p for p in lin.parameters()] == masters  # the masters are back
    y.float().sum().backward()
    w, b = lin[0].weight, lin[0].bias
    assert w.grad.dtype == torch.float32 and b.grad.dtype == torch.float32
    # the gradient of sum(x W^T + b) is the bf16 column sum of x, widened
    want = x.bfloat16().sum(0).float().expand_as(w)
    torch.testing.assert_close(w.grad, want, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(b.grad, torch.full((4,), 5.0))
    with precision.cast_parameters(lin, torch.float32):  # a no-op for f32
        assert lin[0].weight is masters[0]


def test_matmul_takes_mixed_operands_as_jax_does():
    x = torch.randn(3, 5)
    w = torch.randn(5, 2).bfloat16()
    with precision.compute_dtype(torch.bfloat16):
        got = precision.matmul(x, w)
    assert got.dtype == torch.bfloat16
    want = (x @ w.float()).bfloat16()  # f32 product, rounded once
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert precision.matmul(x, w.float()).dtype == torch.float32


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_layers_round_the_product_before_the_bias_as_jax_does(kind):
    """The port's ``Linear`` and ``Conv1d`` under the policy against the JAX
    package's under its ``compute_dtype``, on the same bf16 weights and
    input, equal in bits: the product rounded to bf16, then the bias (a
    fused call rounds once, and differs by a bf16 unit on some entries where
    the bias is not small against the product). In f32 they are
    ``torch.nn``'s layers bit for bit, and ``product_dtypes`` counts what
    each call returned."""
    from rtvc_tpu.models import layers as jl
    from rtvc_tpu_torch.models import layers as tl

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    if kind == "linear":
        jmod, tmod, ref = jl.Linear(12), tl.Linear(16, 12), torch.nn.Linear(16, 12)
    else:
        jmod, tmod = jl.Conv1d(12, 5, padding=2), tl.Conv1d(16, 12, 5, padding=2)
        ref = torch.nn.Conv1d(16, 12, 5, padding=2)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {**params, "bias": params["bias"] + 4.0}  # a bias the product's size
    state = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tmod.load_state_dict(state)
    ref.load_state_dict(state)
    with jprecision.compute_dtype(jnp.bfloat16):
        want = jmod.apply({"params": jprecision.cast_floats(params, jnp.bfloat16)},
                          jnp.asarray(x, jnp.bfloat16))
    with precision.policy(tmod, torch.bfloat16), precision.product_dtypes() as products:
        got = tmod(precision.cast_floats(torch.from_numpy(x), torch.bfloat16))
    assert got.dtype == torch.bfloat16 and dict(products) == {torch.bfloat16: 1}
    torch.testing.assert_close(got.float(), torch.from_numpy(_np(want).copy()), rtol=0, atol=0)
    xt = torch.from_numpy(x)
    want32 = ref(xt) if kind == "linear" else ref(xt.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(tmod(xt), want32, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K3 and K4 on bf16 streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,seed", [(2, 0), (3, 1)])
def test_bf16_lstm_matches_jax_fused_interpret(monkeypatch, B, seed):
    T, H = 8, 128
    # one time tile of T steps: with T padded to a longer tile the JAX
    # wrapper reads h_T and c_T back from the bf16 ys and cs streams, where
    # its kernel's own contract (and the port's) keeps them f32
    monkeypatch.setenv("RTVC_LSTM_TRAIN_TILE", str(T))
    rng = np.random.default_rng(seed)
    jxg, txg = _bf16(rng.standard_normal((B, T, 4 * H)))
    jw, tw = _bf16(rng.uniform(-0.1, 0.1, (4 * H, H)))
    h0 = rng.standard_normal((B, H)).astype(np.float32) * 0.3
    c0 = rng.standard_normal((B, H)).astype(np.float32) * 0.3
    cots = (rng.standard_normal((B, T, H)), rng.standard_normal((B, H)),
            rng.standard_normal((B, H)))
    (ys, hT, cT), vjp = jax.vjp(lambda w, x, h, c: lstm_seq_fused(w, x, h, c, True),
                                jw.T, jxg, jnp.asarray(h0), jnp.asarray(c0))
    jcot = (jnp.asarray(cots[0], jnp.bfloat16), jnp.asarray(cots[1], jnp.float32),
            jnp.asarray(cots[2], jnp.float32))
    dw_t, dxg, dh0, dc0 = vjp(jcot)

    txg.requires_grad_()
    tw.requires_grad_()
    th0 = torch.from_numpy(h0).requires_grad_()
    tc0 = torch.from_numpy(c0).requires_grad_()
    got = k3.LSTMSeqFn.apply(txg, tw, th0, tc0)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    g = torch.autograd.grad(got, (txg, tw, th0, tc0),
                            (torch.from_numpy(np.asarray(jcot[0].astype(jnp.float32))).bfloat16(),
                             torch.from_numpy(cots[1]).float(), torch.from_numpy(cots[2]).float()))
    assert [t.dtype for t in g] == [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]
    np.testing.assert_allclose(_np(got[0]), _np(ys), **BF16, err_msg="ys")
    np.testing.assert_allclose(_np(got[1]), _np(hT), atol=1e-4, err_msg="h_T")
    np.testing.assert_allclose(_np(got[2]), _np(cT), atol=1e-4, err_msg="c_T")
    np.testing.assert_allclose(_np(g[0]), _np(dxg), **BF16, err_msg="dxg")
    # dW_hh sums B·T products whose dxg reads the bf16 cell residual cs: where
    # the two frameworks' f32 cells round to neighbouring bf16 values, dxg
    # moves by ~2e-4 and a sum that cancels to 1e-4 of its terms moves with
    # it, so its small entries are held within 1e-3 of the largest one
    ref = _np(dw_t).T
    np.testing.assert_allclose(_np(g[1]), ref, rtol=BF16["rtol"],
                               atol=1e-3 * float(np.abs(ref).max()), err_msg="dW_hh")
    np.testing.assert_allclose(_np(g[2]), _np(dh0), atol=1e-4, err_msg="dh0")
    np.testing.assert_allclose(_np(g[3]), _np(dc0), atol=1e-4, err_msg="dc0")


@pytest.mark.parametrize("B,seed", [(2, 0), (3, 1)])
def test_bf16_gru_matches_jax_fused_interpret(B, seed):
    T, H = 8, 128
    rng = np.random.default_rng(seed)
    jxg, txg = _bf16(rng.standard_normal((B, T, 3 * H)))
    jw, tw = _bf16(rng.uniform(-0.1, 0.1, (3 * H, H)))
    jb, tb = _bf16(rng.uniform(-0.1, 0.1, (3 * H,)))
    jdys, tdys = _bf16(rng.standard_normal((B, T, H)))
    ys, vjp = jax.vjp(lambda w, b, x: gru_seq_fused(w, b, x, True), jw.T, jb, jxg)
    dw_t, db, dxg = vjp(jdys)

    for t in (txg, tw, tb):
        t.requires_grad_()
    got = k4.GRUSeqFn.apply(txg, tw, tb)
    g = torch.autograd.grad(got, (txg, tw, tb), tdys)
    assert got.dtype == torch.bfloat16 and {t.dtype for t in g} == {torch.bfloat16}
    np.testing.assert_allclose(_np(got), _np(ys), **BF16, err_msg="ys")
    np.testing.assert_allclose(_np(g[0]), _np(dxg), **BF16, err_msg="dxg")
    np.testing.assert_allclose(_np(g[1]), _np(dw_t).T, **BF16, err_msg="dW_hh")
    np.testing.assert_allclose(_np(g[2]), _np(db), **BF16, err_msg="db_hh")


def test_bf16_plain_versions_keep_the_state_f32():
    """The bf16 plain forward is the f32 forward on the same (bf16-valued)
    inputs with its streams rounded once: the state is never rounded."""
    rng = np.random.default_rng(2)
    B, T, H = 2, 12, 16
    xg = torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (4 * H, H)).astype(np.float32)).bfloat16()
    h0 = torch.zeros(B, H)
    lo = k3.lstm_seq_fwd_train_plain(xg, w, h0, h0)
    hi = k3.lstm_seq_fwd_train_plain(xg.float(), w.float(), h0, h0)
    for a, b in zip(lo, hi):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0)
    xg = torch.from_numpy(rng.standard_normal((B, T, 3 * H)).astype(np.float32)).bfloat16()
    w3, b3 = w[:3 * H], torch.zeros(3 * H).bfloat16()
    lo = k4.gru_seq_fwd_plain(xg, w3, b3)
    hi = k4.gru_seq_fwd_plain(xg.float(), w3.float(), b3.float())
    for a, b in zip(lo, hi):
        torch.testing.assert_close(a, b.bfloat16(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5 cast around its launch
# ---------------------------------------------------------------------------

K5_SHAPE = dict(B=3, T=20, n=6, D=128, L=128, E=128)
STREAMS = ("xg_pre", "enc_seq", "enc_proj")


def _k5_case(seed=0):
    w, x = make_case(**K5_SHAPE, seed=seed)
    for k in STREAMS:  # the bf16 policy's streams: bf16 values
        x[k] = np.asarray(jnp.asarray(x[k], jnp.bfloat16).astype(jnp.float32))
    tw = tk.TrainWeights(*(torch.from_numpy(w[k]).requires_grad_() for k in tk.TrainWeights._fields))
    tx = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    for k in STREAMS:
        tx[k] = tx[k].bfloat16().requires_grad_()
    return w, x, tw, tx


def test_k5_cast_around_forward_matches_pallas_interpret_on_bf16():
    w, x, tw, tx = _k5_case()
    with torch.no_grad():
        got = tk.taco_decoder_train(tw, **tx)
    assert {t.dtype for t in got} == {torch.float32}  # the attention's f32 island
    ji = list(jax_inputs(x))
    ji[:3] = [a.astype(jnp.bfloat16) for a in ji[:3]]
    want = jk.taco_decoder_train_fused(jax_weights(w), *ji[:4], jnp.zeros_like(ji[3]), *ji[4:],
                                       interpret=True)
    for name, a, b in zip(("x", "ctx", "scores"), got, want):
        assert b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)


def test_k5_cast_around_cotangents_come_back_bf16():
    w, x, tw, tx = _k5_case(seed=1)
    s = K5_SHAPE
    cots = cotangents(s["n"], s["B"], s["T"], s["L"], s["E"])
    ji = jax_inputs(x)
    # the JAX kernel's cast-around: bf16 inputs widened before the f32 chain
    _, vjp = jax.vjp(lambda wt, xg, es, ep: scan_chain(
        wt, xg.astype(jnp.float32), es.astype(jnp.float32), ep.astype(jnp.float32), *ji[3:]),
        jax_weights(w), *(a.astype(jnp.bfloat16) for a in ji[:3]))
    g_w, *g_x = vjp(tuple(jnp.asarray(c) for c in cots))
    outs = tk.taco_decoder_train(tw, **tx)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    tol = 5e-4
    for name, gw in zip(tk.TrainWeights._fields, g_w):
        got = getattr(tw, name).grad
        assert got.dtype == torch.float32, name
        ref = np.asarray(gw)[:31] if name == "mloc" else np.asarray(gw)
        ref = ref.reshape(got.shape)
        scale = max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=tol, atol=tol,
                                   err_msg=name)
    for name, gx in zip(STREAMS, g_x):
        got = tx[name].grad
        assert got.dtype == torch.bfloat16 and gx.dtype == jnp.bfloat16, name
        ref = _np(gx)
        scale = max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(_np(got) / scale, ref / scale, rtol=tol + BF16_ULP, atol=tol,
                                   err_msg=name)
