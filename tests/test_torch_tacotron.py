"""Tacotron pieces and K2 (the decoder loop) against the JAX package, with
prenet dropout off (f32 on the CPU; 1e-5 for the encoder, decoder step and
postnet; mel 1e-5 and attention 1e-6 for the decoder loop, as the JAX
package holds its own kernel to the scan)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvc_tpu.models import tacotron as jt
from rtvc_tpu.ops.pallas.tacotron_kernel import decode_pallas
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as tt
from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode, tacotron_decode_plain

DIMS = dict(
    num_chars=40, n_mels=16, fft_bins=16, speaker_embedding_size=24,
    embed_dims=16, encoder_dims=8, decoder_dims=16, postnet_dims=8,
    encoder_K=2, postnet_K=2, num_highways=2, lstm_dims=16,
    max_r=4, dropout=0.5, stop_threshold=-3.4,
)


@pytest.fixture(scope="module")
def setup():
    jd, td = jt.TacotronDims(**DIMS), tt.TacotronDims(**DIMS)
    model = factories.init_tacotron(td, seed=0, device="cpu")
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5) if name.endswith("var") else buf.normal_(0, 0.2)
    v = jt.import_torch_state(model.state_dict(), jd)
    rng = np.random.default_rng(0)
    chars = np.where(np.arange(16)[None, :] < 12, rng.integers(1, 40, (2, 16)),
                     0).astype(np.int32)
    spk = rng.standard_normal((2, 24)).astype(np.float32)
    return jd, td, v, model, chars, spk


def _jax_encode_nodrop(v, d, chars, spk):
    """The JAX encoder chain with the prenet's dropout off."""
    mods = jt._modules(d)
    x = jt._apply(mods, v, "embedding", jnp.asarray(chars))
    x = jt._prenet_nodrop(v["params"]["enc_prenet"], x, jnp.float32)
    x = jt._apply(mods, v, "enc_cbhg", x, train=False)
    e = jnp.broadcast_to(jnp.asarray(spk)[:, None, :], x.shape[:2] + (spk.shape[-1],))
    seq = jnp.concatenate([x, e], axis=-1)
    return seq, jt._apply(mods, v, "encoder_proj", seq)


def _torch_encode(model, chars, spk):
    with torch.no_grad():
        return tt.encode(model, torch.from_numpy(chars), torch.from_numpy(spk),
                         prenet_dropout=False)


def test_encode_matches(setup):
    jd, td, v, model, chars, spk = setup
    j_seq, j_proj = _jax_encode_nodrop(v, jd, chars, spk)
    t_seq, t_proj = _torch_encode(model, chars, spk)
    np.testing.assert_allclose(t_seq.numpy(), np.asarray(j_seq), atol=1e-5)
    np.testing.assert_allclose(t_proj.numpy(), np.asarray(j_proj), atol=1e-5)


def test_decoder_steps_match(setup):
    jd, td, v, model, chars, spk = setup
    j_seq, j_proj = _jax_encode_nodrop(v, jd, chars, spk)
    t_seq, t_proj = torch.tensor(np.asarray(j_seq)), torch.tensor(np.asarray(j_proj))
    mask = (chars != 0).astype(np.float32)
    jc, tc = jt.init_decoder_carry(jd, 2, 16), tt.init_decoder_carry(td, 2, 16)
    jprev, tprev = jnp.zeros((2, 16)), torch.zeros((2, 16))
    for i in range(4):
        jc, jm, js, jstop = jt.decoder_step(
            v["params"], jd, 2, jc, jprev, j_seq, j_proj, jnp.asarray(mask),
            jax.random.PRNGKey(i), False, prenet_dropout=False)
        with torch.no_grad():
            tc, tm, ts, tstop = tt.decoder_step(
                model, td, 2, tc, tprev, t_seq, t_proj, torch.from_numpy(mask),
                prenet_dropout=False)
        for a, b in ((tm, jm), (ts, js), (tstop, jstop), (tc.cumulative, jc.cumulative),
                     (tc.context_vec, jc.context_vec), (tc.rnn2_cell, jc.rnn2_cell)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        jprev, tprev = jm[:, :, -1], tm[:, :, -1]


@pytest.mark.parametrize("lengths", [None, [20, 13]])
def test_postnet_matches(setup, lengths):
    jd, td, v, model, chars, spk = setup
    mels = np.random.default_rng(3).uniform(-4, 4, (2, 16, 20)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths)
    ref, _ = jt._postnet(v, jd, jnp.asarray(mels), False, None, lengths=jl)
    with torch.no_grad():
        got = tt.postnet(model, torch.from_numpy(mels),
                         None if lengths is None else torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_plain_matches_pallas_kernel(setup):
    jd, td, v, model, chars, spk = setup
    j_seq, j_proj = _jax_encode_nodrop(v, jd, chars, spk)
    mask = (chars != 0).astype(np.float32)
    r, max_steps = 2, 24
    jm, ja, js = decode_pallas(v, jd, j_seq, j_proj, jnp.asarray(mask),
                               jax.random.PRNGKey(3), r=r, max_steps=max_steps,
                               dropout=False, interpret=True)
    args = (model, td, torch.tensor(np.asarray(j_seq)),
            torch.tensor(np.asarray(j_proj)), torch.from_numpy(mask), 0, r,
            max_steps)
    with torch.no_grad():
        tm, ta, ts = tacotron_decode_plain(*args, dropout=False)
        tm2, _, _ = tacotron_decode(*args, dropout=False)  # CPU → plain version
    assert torch.equal(tm, tm2)
    n_j = tt.stop_iterations(torch.tensor(np.asarray(js)), r)
    n_t = tt.stop_iterations(ts, r)
    assert n_t == n_j
    np.testing.assert_allclose(tm.numpy()[:, :, :n_t * r], np.asarray(jm)[:, :, :n_t * r],
                               atol=1e-5)
    np.testing.assert_allclose(ta.numpy()[:, :n_t], np.asarray(ja)[:, :n_t], atol=1e-6)
    np.testing.assert_allclose(ts.numpy()[:, :n_t], np.asarray(js)[:, :n_t], atol=1e-5)
    # past the stop everything is zero, in both
    assert np.abs(tm.numpy()[:, :, n_t * r:]).max(initial=0.0) == 0.0
    assert np.abs(np.asarray(jm)[:, :, n_t * r:]).max(initial=0.0) == 0.0


def test_decode_stops_early_and_zeroes_the_tail(setup):
    jd, td, v, model, chars, spk = setup
    with torch.no_grad():
        model.decoder.stop_proj.bias.fill_(30.0)  # every stop token fires
        try:
            seq, proj = _torch_encode(model, chars, spk)
            mask = torch.from_numpy((chars != 0).astype(np.float32))
            mel, attn, stops = tacotron_decode_plain(model, td, seq, proj, mask, 0, 2,
                                                     40, dropout=False)
        finally:
            model.decoder.stop_proj.bias.copy_(torch.from_numpy(
                np.asarray(v["params"]["stop_proj"]["bias"])))
    n = tt.stop_iterations(stops, 2)
    assert n == 7  # iteration 6 is the first with i·r > 10
    assert (stops[:, :n] > 0.5).all() and (stops[:, n:] == 0).all()
    assert mel[:, :, n * 2:].abs().max() == 0 and attn[:, n:].abs().max() == 0


def test_decode_dropout_is_seeded(setup):
    jd, td, v, model, chars, spk = setup
    seq, proj = _torch_encode(model, chars, spk)
    mask = torch.from_numpy((chars != 0).astype(np.float32))

    def run(seed):
        with torch.no_grad():
            return tacotron_decode_plain(model, td, seq, proj, mask, seed, 2, 12)[0]

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))


def test_tacotron_generate_chains_the_pieces(setup):
    """The plain generate path: encode → decoder loop → length-exact postnet
    over the decoded frames (the JAX postnet on the same mel and lengths)."""
    jd, td, v, model, chars, spk = setup
    t_chars, t_spk = torch.from_numpy(chars), torch.from_numpy(spk)
    with torch.no_grad():
        mel, linear, attn, n_valid = tt.tacotron_generate(
            model, td, t_chars, t_spk, 2, seed=0, max_steps=24, compute_linear=True,
            prenet_dropout=False)
        seq, proj = tt.encode(model, t_chars, t_spk, prenet_dropout=False)
        ref_mel, ref_attn, ref_stops = tacotron_decode_plain(
            model, td, seq, proj, t_chars.ne(0).float(), 0, 2, 24, dropout=False)
    assert torch.equal(mel, ref_mel) and torch.equal(attn, ref_attn)
    assert n_valid == tt.stop_iterations(ref_stops, 2) * 2
    ref_linear, _ = jt._postnet(v, jd, jnp.asarray(mel.numpy()), False, None,
                                lengths=jnp.full((2,), n_valid))
    np.testing.assert_allclose(linear.numpy(), np.swapaxes(np.asarray(ref_linear), 1, 2),
                               atol=1e-5)
