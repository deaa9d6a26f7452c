"""K5's plain versions against the JAX package (f32 on the CPU).

  * forward: ``taco_train_fwd_plain`` against the Pallas kernel
    ``taco_decoder_train_fused(..., interpret=True)`` at D = L = E = 128,
    B 3, T_text 20, 6 iterations, random {0, 1} zoneout masks and a padded
    char mask, rtol 2e-4 / atol 2e-5 (the tolerance the JAX package holds
    its own kernel to: the two sum in another order);
  * backward: the hand-written ``taco_train_bwd_plain`` (through
    ``TacoDecoderTrainFn``) against ``jax.vjp`` of a ``lax.scan`` of the same
    chain built from the JAX package's ``gru_step`` / ``lstm_cell_step``:
    every input's and every weight's gradient within 5e-4 of the
    reference's largest entry; one case runs the Pallas kernel's own VJP in
    interpret mode (about a minute, marked slow);
  * ``TacoDecoderTrainFn`` through ``torch.autograd.gradcheck`` in float64;
  * ``prepare_train_weights`` against the JAX package's on shared
    parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.models.layers import gru_step, lstm_cell_step
from rtvc_tpu.ops.pallas import tacotron_train_kernel as jk
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.ops import tacotron_train as tk

WEIGHT_SHAPES = dict(gwh=("D", "3D"), gbh=("3D",), wq=("D", "D"), bq=("D",), mloc=("KS", "D"),
                     vv=("D",), wri=("E+D", "L"), bri=("L",), l1wi=("L", "4L"),
                     l1wh=("L", "4L"), l1b=("4L",), l2wi=("L", "4L"), l2wh=("L", "4L"),
                     l2b=("4L",), gwi_ctx=("E", "3D"))


def make_case(B, T, n, D, L, E, seed=0, KS=31, dtype=np.float32):
    """Weights and inputs from a numpy seed: (weights dict, inputs dict)."""
    rng = np.random.default_rng(seed)
    sizes = {"D": D, "3D": 3 * D, "L": L, "4L": 4 * L, "E": E, "E+D": E + D, "KS": KS}

    def r(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(dtype)

    w = {k: r(*(sizes[a] for a in shape)) for k, shape in WEIGHT_SHAPES.items()}
    lens = rng.integers(max(T - 8, 1), T + 1, B)
    x = dict(xg_pre=r(n, B, 3 * D, s=1.0), enc_seq=r(B, T, E, s=0.5), enc_proj=r(B, T, D, s=0.5),
             char_mask=(np.arange(T)[None, :] < lens[:, None]).astype(dtype),
             zo1=(rng.random((n, B, L)) < 0.1).astype(dtype),
             zo2=(rng.random((n, B, L)) < 0.1).astype(dtype))
    return w, x


def jax_weights(w):
    """The port's weights in the Pallas kernel's layout: row vectors (1, ·)
    and mloc padded to 32 taps."""
    j = {k: jnp.asarray(v if v.ndim == 2 else v[None]) for k, v in w.items()}
    j["mloc"] = jnp.concatenate([j["mloc"], jnp.zeros((1, w["mloc"].shape[1]), jnp.float32)], 0)
    return tuple(j[k] for k in tk.TrainWeights._fields)


def torch_case(w, x, grad=False):
    tw = tk.TrainWeights(**{k: torch.tensor(v, requires_grad=grad) for k, v in w.items()})
    tx = {k: torch.tensor(v, requires_grad=grad and k in ("xg_pre", "enc_seq", "enc_proj"))
          for k, v in x.items()}
    return tw, tx


def scan_chain(weights, xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2):
    """The chain as a ``lax.scan`` of the JAX package's cells
    (``models/tacotron.py:_decoder_recurrence`` with the zoneout masks given
    and the location term through ``mloc``)."""
    (gwh, gbh, wq, bq, mloc, vv, wri, bri, l1wi, l1wh, l1b, l2wi, l2wh, l2b, gwi_ctx) = weights
    B, T = char_mask.shape
    D, L = gwh.shape[0], wri.shape[1]
    zeros_b = jnp.zeros((4 * L,))

    def lstm(x, h, c, wi, wh, b, zo):
        h_new, c = lstm_cell_step({"weight_ih": wi.T, "weight_hh": wh.T, "bias_ih": b[0],
                                   "bias_hh": zeros_b}, x, h, c)
        return zo * h + (1.0 - zo) * h_new, c

    def body(carry, inp):
        ah, h1, c1, h2, c2, ctx, cum = carry
        xg_p, z1, z2 = inp
        ah = gru_step(xg_p + ctx @ gwi_ctx, ah, gwh, gbh[0])
        cp = jnp.pad(cum, ((0, 0), (15, 15)))
        win = jnp.stack([cp[:, k:k + T] for k in range(31)], axis=2)
        tv = jnp.tanh((ah @ wq + bq[0])[:, None, :] + enc_proj + win @ mloc[:31])
        scores = jax.nn.softmax((tv @ vv[0]) * char_mask, axis=1)
        cum = cum + scores
        ctx = jnp.einsum("bt,btc->bc", scores, enc_seq)
        x0 = jnp.concatenate([ctx, ah], axis=1) @ wri + bri[0]
        h1, c1 = lstm(x0, h1, c1, l1wi, l1wh, l1b, z1)
        h2, c2 = lstm(x0 + h1, h2, c2, l2wi, l2wh, l2b, z2)
        return (ah, h1, c1, h2, c2, ctx, cum), (x0 + h1 + h2, ctx, scores)

    z = jnp.zeros
    carry0 = (z((B, D)), z((B, L)), z((B, L)), z((B, L)), z((B, L)),
              z((B, enc_seq.shape[2])), z((B, T)))
    return jax.lax.scan(body, carry0, (xg_pre, zo1, zo2))[1]


def jax_inputs(x):
    return tuple(jnp.asarray(x[k]) for k in ("xg_pre", "enc_seq", "enc_proj", "char_mask",
                                             "zo1", "zo2"))


def cotangents(n, B, T, L, E, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((n, B, L), (n, B, E), (n, B, T))]


def torch_grads(w, x, cots):
    tw, tx = torch_case(w, x, grad=True)
    outs = tk.taco_decoder_train(tw, **tx)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    grads = {k: getattr(tw, k).grad.numpy() for k in tw._fields}
    grads.update({k: tx[k].grad.numpy() for k in ("xg_pre", "enc_seq", "enc_proj")})
    return grads


def assert_grads_close(got, want_weights, want_inputs, tol=5e-4):
    want = dict(zip(tk.TrainWeights._fields, want_weights))
    want.update(zip(("xg_pre", "enc_seq", "enc_proj"), want_inputs))
    for name, g in got.items():
        ref = np.asarray(want[name])
        if name == "mloc":
            ref = ref[:31]
        ref = ref.reshape(g.shape)
        scale = max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(g / scale, ref / scale, rtol=tol, atol=tol, err_msg=name)


SHAPES = {"mid": dict(B=3, T=20, n=6, D=128, L=128, E=128),
          "odd": dict(B=1, T=21, n=5, D=128, L=128, E=128)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_forward_matches_pallas_interpret(shape):
    w, x = make_case(**SHAPES[shape])
    tw, tx = torch_case(w, x)
    x_all, res = tk.taco_train_fwd_plain(tw, **tx)
    ji = jax_inputs(x)
    want = jk.taco_decoder_train_fused(jax_weights(w), *ji[:4], jnp.zeros_like(ji[3]), *ji[4:],
                                       interpret=True)
    for name, a, b in zip(("x", "ctx", "scores"), (x_all, res.ctx, res.scores), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)
    # the residuals the backward reads are consistent with the outputs
    torch.testing.assert_close(res.x0 + res.h1 + res.h2, x_all)
    torch.testing.assert_close(res.scores.sum(0), res.cum_T)
    assert set(np.unique(res.scores.sum(-1).round(decimals=4).numpy())) == {1.0}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_matches_jax_vjp_of_scan(shape):
    s = SHAPES[shape]
    w, x = make_case(**s)
    cots = cotangents(s["n"], s["B"], s["T"], s["L"], s["E"])
    ji = jax_inputs(x)
    out, vjp = jax.vjp(lambda wt, xg, es, ep: scan_chain(wt, xg, es, ep, *ji[3:]),
                       jax_weights(w), *ji[:3])
    tw, tx = torch_case(w, x)
    x_all, res = tk.taco_train_fwd_plain(tw, **tx)
    for a, b in zip((x_all, res.ctx, res.scores), out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    g_w, *g_x = vjp(tuple(jnp.asarray(c) for c in cots))
    assert_grads_close(torch_grads(w, x, cots), g_w, g_x)


@pytest.mark.slow  # the Pallas kernel's VJP in interpret mode takes about a minute
def test_plain_backward_matches_pallas_vjp_interpret():
    s = SHAPES["mid"]
    w, x = make_case(**s)
    cots = cotangents(s["n"], s["B"], s["T"], s["L"], s["E"])
    ji = jax_inputs(x)
    _, vjp = jax.vjp(lambda wt, xg, es, ep: jk.taco_decoder_train_fused(
        wt, xg, es, ep, ji[3], jnp.zeros_like(ji[3]), *ji[4:], interpret=True),
        jax_weights(w), *ji[:3])
    g_w, *g_x = vjp(tuple(jnp.asarray(c) for c in cots))
    assert_grads_close(torch_grads(w, x, cots), g_w, g_x)


def test_backward_cotangent_streams_match_autograd_of_plain_forward():
    """The per-step cotangents the backward emits (what the kernel writes)
    against autograd through the plain forward, in float64."""
    w, x = make_case(B=2, T=9, n=4, D=6, L=5, E=7, KS=5, dtype=np.float64)
    tw, tx = torch_case(w, x, grad=True)
    x_all, res = tk.taco_train_fwd_plain(tw, **tx)
    rng = np.random.default_rng(3)
    cots = [torch.tensor(rng.standard_normal(t.shape)) for t in (x_all, res.ctx, res.scores)]
    torch.autograd.backward((x_all, res.ctx, res.scores), cots)
    with torch.no_grad():
        c = tk.taco_train_bwd_plain(tw, res, tx["enc_seq"], tx["enc_proj"], tx["char_mask"],
                                    tx["zo1"], tx["zo2"], *cots)
    torch.testing.assert_close(c.dxg4[..., :18], tx["xg_pre"].grad)
    torch.testing.assert_close(c.denc_seq, tx["enc_seq"].grad)
    torch.testing.assert_close(c.denc_proj, tx["enc_proj"].grad)
    torch.testing.assert_close(c.dv, tw.vv.grad)
    torch.testing.assert_close(c.dmloc, tw.mloc.grad)
    torch.testing.assert_close(c.dq.sum((0, 1)), tw.bq.grad)
    torch.testing.assert_close(c.dx0.sum((0, 1)), tw.bri.grad)
    torch.testing.assert_close(c.dgates1.sum((0, 1)), tw.l1b.grad)
    torch.testing.assert_close(c.dgates2.sum((0, 1)), tw.l2b.grad)


def test_function_gradcheck_float64():
    w, x = make_case(B=2, T=7, n=3, D=4, L=3, E=5, KS=5, seed=1, dtype=np.float64)
    tw, tx = torch_case(w, x, grad=True)
    args = (tx["xg_pre"], tx["enc_seq"], tx["enc_proj"], tx["char_mask"], tx["zo1"], tx["zo2"],
            *tw)
    assert torch.autograd.gradcheck(tk.TacoDecoderTrainFn.apply, args, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_prepare_train_weights_matches_jax():
    dims = dict(num_chars=20, n_mels=6, fft_bins=6, speaker_embedding_size=24, embed_dims=8,
                encoder_dims=8, decoder_dims=16, postnet_dims=8, encoder_K=2, postnet_K=2,
                num_highways=1, lstm_dims=12, max_r=3, dropout=0.5, stop_threshold=-3.4)
    jd, td = jt.TacotronDims(**dims), tt.TacotronDims(**dims)
    v = jt.init_tacotron(jax.random.PRNGKey(0), jd)
    from rtvc_tpu_torch import bridge

    model = tt.Tacotron(td)
    model.load_state_dict(bridge.tacotron_state(v))
    E = td.enc_out_dims
    want = jk.prepare_train_weights(v["params"], jd, E)
    got = tk.prepare_train_weights(model.decoder, E)
    assert got.dims == (16, 12, E, 31)
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)[:31] if name == "mloc" else np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b.reshape(a.shape), atol=1e-6,
                                   err_msg=name)


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    w, x = make_case(B=2, T=6, n=2, D=8, L=4, E=4, KS=3)
    tw, tx = torch_case(w, x)
    a, ra = tk.taco_train_fwd(tw, **tx)
    b, rb = tk.taco_train_fwd_plain(tw, **tx)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for u, v in zip(ra, rb):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
