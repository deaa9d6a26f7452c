"""The partition of K2 (the Tacotron generate decoder) over the card:
``ops/tacotron_decode.py:plan`` is pure, so no card is needed. A plan must
give every unit of every cut (and so every row of every product) to exactly
one CTA, lay out a CTA's shared memory without overlaps inside the limit,
and lay out the workspace; or refuse with a ValueError that names the
limit."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtvc_tpu_torch.ops import tacotron_decode as td

H100 = (132, 232448)  # SMs, bytes of shared memory a block may opt in to
FULL = td.DecoderShape(E=896, D=256, L=512, P=512, M=80, max_r=20, NF=32, KS=31)
SMALL = td.DecoderShape(E=32, D=16, L=16, P=32, M=16, max_r=4, NF=32, KS=31)
ODD = td.DecoderShape(E=13, D=13, L=11, P=26, M=7, max_r=5, NF=7, KS=5)


def _al4(n):
    return -(-n // 4) * 4


def _regions(p, s, B, T, r):
    """Every shared-memory region of the plan as (name, start, floats, phase):
    phase is the phase whose chained products share it, else None."""
    sm = dict(zip(td.SMEM_SLOTS, p.sm))
    q = dict(zip(td.CUTS, p.q))
    prods = td.products(s, r)
    regions = []
    for k, (name, pr) in enumerate(prods.items()):
        rows = pr.gates * q[pr.cut]
        if p.w_off[k] >= 0:
            regions.append((f"w:{name}", p.w_off[k], rows * _al4(pr.n), None))
        regions.append((f"out:{name}", p.out_off[k], p.ks[k] * rows * B,
                        pr.phase if pr.chained else None))
    sizes = {"c1": q["lstm"] * B, "c2": q["lstm"] * B, "v": s.D, "conv_w": s.NF * s.KS,
             "conv_b": s.NF, "soft": sm["soft_rows"] * _al4(T), "scratch": td.WARPS * 32,
             "part": max(4 * td.THREADS, sm["conv_pairs"] * td.MAX_FILTERS),
             "bias": td._bias_floats(q), "ah_own": q["gru"] * B, "x0_own": q["ri"] * B,
             "x1_own": q["lstm"] * B, "qs": sm["soft_rows"] * _al4(s.D)}
    regions += [(name, sm[name], n, None) for name, n in sizes.items()]
    return regions


def _check_plan(B, T, s, r, sm_count, smem_limit, **kw):
    p = td.plan(B, T, s, r, sm_count, smem_limit, **kw)
    assert 1 <= p.ctas <= sm_count
    assert p.nb in td.NB_CHOICES and p.resident in (0, 1)
    assert len(p.ints()) == 4 + 2 * len(td.CUTS) + 3 * len(td.PRODUCTS) + len(td.SMEM_SLOTS) \
        + len(td.WS_SLOTS)
    # every unit of every cut in exactly one CTA (so every row of every
    # product: a unit's gate rows go with it)
    sizes = td.cut_sizes(s, B, T)
    for cut, n in sizes.items():
        owned = sorted(u for c in range(p.ctas) for u in p.owned(cut, n, c))
        assert owned == list(range(n)), cut
    q = dict(zip(td.CUTS, p.q))
    assert q["ctx"] % 4 == 0  # the context is summed in groups of 4 columns
    # rnn_input's rows and the LSTMs' units go to the same CTAs: the residual
    # stays in shared memory
    assert [p.owned("ri", s.L, c) for c in range(p.ctas)] == \
        [p.owned("lstm", s.L, c) for c in range(p.ctas)]
    # the softmax rows a CTA needs fit its buffer
    sm = dict(zip(td.SMEM_SLOTS, p.sm))
    for c in range(p.ctas):
        rows = set()
        for cut, width in (("pair", T), ("ctx", s.E)):
            rows |= {u // width for u in p.owned(cut, sizes[cut], c)}
        if rows:
            assert max(rows) - min(rows) + 1 <= sm["soft_rows"]
    # reduction pieces of whole chunks of 128 floats, none of them empty
    for k, pr in enumerate(td.products(s, r).values()):
        chunks = -(-pr.n // td.CHUNK)
        assert 1 <= p.ks[k] <= chunks and (p.ks[k] - 1) * -(-chunks // p.ks[k]) < chunks
    # shared memory: no two regions overlap unless they are chained products
    # of different phases, all inside [HEADER, end), and within the limit
    regions = _regions(p, s, B, T, r)
    for i, (n1, a1, l1, ph1) in enumerate(regions):
        assert a1 % 4 == 0 and a1 >= td.HEADER and a1 + l1 <= sm["end"], n1
        for n2, a2, l2, ph2 in regions[i + 1:]:
            if ph1 is not None and ph2 is not None and ph1 != ph2:
                continue
            if l1 and l2:
                assert a1 + l1 <= a2 or a2 + l2 <= a1, (n1, n2)
    assert p.smem == 4 * sm["end"] <= smem_limit
    # the location term's filters share phase F's buffer for the context's pieces
    assert sm["conv_buf"] == sm["part"] and 1 <= sm["conv_pairs"] <= td.CONV_PAIRS
    if not p.resident:
        assert all(o == -1 for o in p.w_off)
    # the workspace: the barrier's 32 words, then each buffer in order
    ws = dict(zip(td.WS_SLOTS, p.ws))
    assert ws["prev"] == 32 and list(p.ws) == sorted(p.ws)
    assert ws["base"] + B * T * _al4(s.D) == ws["u"]
    assert ws["lt"] == ws["stop"] + _al4(B) and ws["total"] == ws["lt"] + _al4(s.NF * s.D)
    return p


def _check_plan_or_limit(B, T, s, r, sm_count, smem_limit):
    try:
        _check_plan(B, T, s, r, sm_count, smem_limit)
    except ValueError as e:
        assert f"past the limit of {smem_limit}" in str(e)


@pytest.mark.parametrize("B,T,r", [(1, 64, 2), (2, 32, 2), (24, 160, 2)])
def test_plan_takes_the_named_shapes_resident(B, T, r):
    """The clone's B 1 (T 64), the smoke's B 2 x T 32 and the synthesis
    batch B 24 x T 160 at r 2 on an H100: the weight slices stay in shared
    memory, 132 CTAs."""
    p = _check_plan(B, T, FULL, r, *H100)
    assert p.resident == 1 and p.ctas == 132
    assert p.nb == (2 if B <= 2 else 8)


@pytest.mark.parametrize("B", [1, 2, 11, 24, 33, 64])
@pytest.mark.parametrize("T", [1, 33, 200, 512])
@pytest.mark.parametrize("r", [1, 2, 7, 20])
def test_plan_covers_the_shape(B, T, r):
    """Any B from 1 to 64, T from 1 to 512 and r from 1 to max_r plans on an
    H100 at the full widths: resident where it fits, else read from L2."""
    _check_plan(B, T, FULL, r, *H100)


@pytest.mark.parametrize("s", [SMALL, ODD])
@pytest.mark.parametrize("sm_count", [1, 3, 16, 132])
@pytest.mark.parametrize("resident", [0, 1])
@pytest.mark.parametrize("nb", td.NB_CHOICES)
def test_plan_forced_choices(s, sm_count, resident, nb):
    """Each forced choice (the profile and the tests use them) plans at
    narrow and odd widths on cards of any size."""
    p = _check_plan(5, 9, s, 3, sm_count, H100[1], resident=resident, nb=nb)
    assert (p.resident, p.nb) == (resident, nb)


def test_plan_names_the_limit():
    with pytest.raises(ValueError, match="past the limit of 32"):
        td.plan(2, 32, FULL._replace(NF=33), 2, *H100)
    with pytest.raises(ValueError, match="past the limit of 4096"):
        td.plan(2, 32, FULL, 2, 132, 4096)
    with pytest.raises(ValueError, match="with its weights resident, past the limit"):
        td.plan(2, 32, FULL, 2, 4, H100[1], resident=1)
    with pytest.raises(ValueError, match="bad plan inputs"):
        td.plan(2, 32, FULL, 21, *H100)
    with pytest.raises(ValueError, match="bad plan inputs"):
        td.plan(0, 32, FULL, 2, *H100)
    with pytest.raises(ValueError, match="nb 3"):
        td.plan(2, 32, FULL, 2, *H100, nb=3)


def test_plan_reads_from_l2_where_the_weights_do_not_fit():
    """r 20 (20 mel rows a channel) and B 64 x T 512 do not leave room for
    the weights in shared memory: the plan reads them from L2."""
    assert _check_plan(1, 64, FULL, 20, *H100).resident == 0
    assert _check_plan(64, 512, FULL, 2, *H100).resident == 0


@settings(max_examples=150, deadline=None)
@given(B=st.integers(1, 64), T=st.integers(1, 512), r=st.integers(1, 20),
       sm_count=st.integers(1, 160), smem_kb=st.integers(8, 227))
def test_plan_property(B, T, r, sm_count, smem_kb):
    _check_plan_or_limit(B, T, FULL, r, sm_count, smem_kb * 1024)


def test_profile_tacotron_variants_match_the_kernel_source():
    """``profile_tacotron`` makes its variants by replacing parts of
    ``csrc/tacotron_decode.cu`` with ``csrc/common.cuh`` written into it:
    every part it names must still be there, and every variant must differ
    from the source and from the others."""
    from rtvc_tpu_torch import profile_lstm
    from rtvc_tpu_torch import profile_tacotron as pt

    source = profile_lstm.flat_source("tacotron_decode.cu")
    made = pt.variants(source)
    assert set(made) == {"base", "no_loads", "no_weights", "no_wait", "phases"}
    assert made["base"] == source and len({*made.values()}) == len(made)
    assert pt.INPUT_LOAD not in made["no_loads"]
    assert pt.WEIGHT_LOAD not in made["no_weights"]
    assert profile_lstm.BARRIER_WAIT not in made["no_wait"]
    # a clock at the loop's start, two at each of the ten barriers, one after
    # each of the eight phases' products
    assert made["phases"].count("clock64()") == 1 + 2 * len(pt.PHASES) + 8
    with pytest.raises(RuntimeError, match="no longer holds"):
        pt.variants(source.replace(pt.WEIGHT_LOAD, ""))
