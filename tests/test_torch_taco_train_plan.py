"""The partition of K5's backward (the Tacotron teacher-forced reverse walk)
over the card: ``ops/tacotron_train.py:plan_bwd`` is pure, so no card is
needed. A plan must give every unit of every cut (so every column of every
product) and every (row, character) pair to exactly one CTA for each batch
row, keep a unit's gate rows in one CTA, lay out a CTA's shared memory
without overlaps inside the limit, and lay out the workspace; or refuse with
a ValueError that names the limit."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtvc_tpu_torch.ops import tacotron_train as tk

H100 = (132, 232448)  # SMs, bytes of shared memory a block may opt in to
FULL = (256, 512, 896, 31)  # D, L, E, KS
SMALL = (16, 8, 24, 5)
ODD = (13, 10, 7, 5)


def _al4(n):
    return -(-n // 4) * 4


def _regions(p, dims, T):
    """Every shared-memory region of the plan as (name, start, floats, phase):
    phase is the phase whose products' sums share it, else None."""
    D, L, E, KS = dims
    sm = dict(zip(tk.BWD_SMEM_SLOTS, p.sm))
    q = dict(zip(tk.BWD_CUTS, p.q))
    regions = []
    for k, (name, (cut, gates, n, phase)) in enumerate(tk.bwd_products(D, L, E).items()):
        if tk.MODES[p.mode] != "l2":
            regions.append((f"w:{name}", p.w_off[k], gates * q[cut] * _al4(n), None))
        regions.append((f"out:{name}", p.out_off[k], p.ks[k] * gates * q[cut] * p.rows, phase))
    for slot, cut in (("dh2", "lstm"), ("dc2", "lstm"), ("hold2", "lstm"), ("dh1", "lstm"),
                      ("dc1", "lstm"), ("hold1", "lstm"), ("dx1", "lstm"), ("dctx", "ctx"),
                      ("dah", "att")):
        regions.append((slot, sm[slot], q[cut] * p.rows, None))
    regions += [("scratch", sm["scratch"], tk.WARPS * -(-tk.ROWS * tk.NB // 32) * 32, None),
                ("rowbuf", sm["rowbuf"], sm["soft_rows"] * sm["row_stride"], None),
                ("wpart", sm["wpart"], max(tk.PAIR_TILE * tk.THREADS, tk.STAGE), None)]
    return regions


def _check_plan(n, B, T, dims, sm_count, smem_limit, **kw):
    D, L, E, KS = dims
    p = tk.plan_bwd(n, B, T, dims, sm_count, smem_limit, **kw)
    mode = tk.MODES[p.mode]
    assert 1 <= p.ctas <= sm_count and p.ctas % p.groups == 0
    assert len(p.ints()) == 5 + len(tk.BWD_CUTS) + 3 * len(tk.BWD_PRODUCTS) \
        + len(tk.BWD_SMEM_SLOTS) + len(tk.BWD_WS_SLOTS)
    # every batch row in exactly one group
    assert sorted(b for g in range(p.groups) for b in p.batch_rows(B, g)) == list(range(B))
    # every unit of every cut (so every column of every product) owned exactly
    # once for each batch row: the CTAs of one group cover the cut
    for cut, size in (("lstm", L), ("ctx", E), ("att", D)):
        for g in range(p.groups):
            owned = sorted(u for c in range(g, p.ctas, p.groups) for u in p.owned(cut, size, c))
            assert owned == list(range(size)), (cut, g)
    pairs = sorted(u for c in range(p.ctas) for u in p.owned("pair", B * T, c))
    assert pairs == list(range(B * T))
    # a unit's gate rows are the rows g·q + j of one CTA's slice (both
    # matrices of an LSTM unit, the GRU's and rnn_input's rows of a column):
    # the slices lie one after another, gates x units of the slice each
    prods = tk.bwd_products(D, L, E)
    q = dict(zip(tk.BWD_CUTS, p.q))
    sizes = [gates * q[cut] * _al4(n_red) for cut, gates, n_red, _ in prods.values()]
    assert list(p.w_off) == [p.w_off[0] + sum(sizes[:k]) for k in range(len(sizes))]
    # the softmax rows a CTA needs fit its buffer
    sm = dict(zip(tk.BWD_SMEM_SLOTS, p.sm))
    for c in range(p.ctas):
        rows = {u // T for u in p.owned("pair", B * T, c)}
        if rows:
            assert max(rows) - min(rows) + 1 <= sm["soft_rows"]
    assert sm["row_stride"] == tk.bwd_row_stride(T, D, E, KS) >= _al4(E)
    # reduction pieces of whole chunks of 128 floats, none empty
    for k, (cut, gates, n_red, _) in enumerate(prods.values()):
        chunks = -(-n_red // tk.CHUNK)
        assert 1 <= p.ks[k] <= chunks and (p.ks[k] - 1) * -(-chunks // p.ks[k]) < chunks
    # shared memory: no overlaps but products' sums of different phases, all
    # inside [HEADER, end), within the limit
    regions = _regions(p, dims, T)
    for i, (n1, a1, l1, ph1) in enumerate(regions):
        assert a1 % 4 == 0 and a1 >= tk.HEADER and a1 + l1 <= sm["end"], n1
        for n2, a2, l2, ph2 in regions[i + 1:]:
            if ph1 is not None and ph2 is not None and ph1 != ph2:
                continue
            if l1 and l2:
                assert a1 + l1 <= a2 or a2 + l2 <= a1, (n1, n2)
    assert p.smem == 4 * sm["end"] <= smem_limit
    # the state the kernel zeroes at the start is one run from dh2 to the sums
    assert sm["dh2"] < sm["dah"] < sm["outs"]
    # the workspace: the barrier's 32 words, then each buffer in order
    ws = dict(zip(tk.BWD_WS_SLOTS, p.ws))
    assert ws["q"] == 32 and list(p.ws) == sorted(p.ws)
    assert ws["dctx"] + n * B * _al4(E) == ws["wl2"]
    assert ws["total"] - ws["wl2"] == (p.ctas * sum(sizes) if mode == "l2" else 0)
    assert p.cost_ms > 0
    return p


@pytest.mark.parametrize("n,B", [(86, 112), (602, 22)])
def test_plan_takes_the_named_shapes(n, B):
    """The first session of the schedule (B 112 x 86 steps) and the last
    (B 22 x 602), T 160 at the full widths on an H100: 132 CTAs, the weight
    slices on chip."""
    p = _check_plan(n, B, 160, FULL, *H100)
    assert p.ctas == 132 and p.name == "resident x1" and p.smem <= H100[1]


@pytest.mark.parametrize("candidate", tk.CANDIDATES)
@pytest.mark.parametrize("n,B", [(86, 112), (602, 22)])
def test_plan_forced_candidates_at_the_named_shapes(candidate, n, B):
    """Every candidate plans at both shapes when forced (the profile and the
    chip smoke time them), and costs no less than the plan's choice."""
    p = _check_plan(n, B, 160, FULL, *H100, candidate=candidate)
    assert (tk.MODES[p.mode], p.groups) == candidate
    best = tk.plan_bwd(n, B, 160, FULL, *H100)
    assert best.cost_ms <= p.cost_ms


@pytest.mark.parametrize("dims", [SMALL, ODD])
@pytest.mark.parametrize("sm_count", [1, 3, 16, 132])
@pytest.mark.parametrize("candidate", tk.CANDIDATES)
def test_plan_forced_candidates_narrow(dims, sm_count, candidate):
    """Each forced candidate plans at narrow and odd widths on cards of any
    size (a card too small for its groups refuses)."""
    try:
        p = _check_plan(4, 5, 9, dims, sm_count, H100[1], candidate=candidate)
    except ValueError:
        assert sm_count < candidate[1]
        return
    assert (tk.MODES[p.mode], p.groups) == candidate


def test_plan_names_the_limit():
    with pytest.raises(ValueError, match="past the limit of 4096"):
        tk.plan_bwd(86, 112, 160, FULL, 132, 4096)
    with pytest.raises(ValueError, match=r"resident x1 needs \d+"):
        tk.plan_bwd(86, 112, 160, FULL, 4, H100[1], candidate=("resident", 1))
    with pytest.raises(ValueError, match="at most 31"):
        tk.plan_bwd(86, 112, 160, (256, 512, 896, 33), *H100)
    with pytest.raises(ValueError, match="odd"):
        tk.plan_bwd(86, 112, 160, (256, 512, 896, 30), *H100)
    with pytest.raises(ValueError, match="bad plan inputs"):
        tk.plan_bwd(0, 112, 160, FULL, *H100)
    with pytest.raises(ValueError, match="not one of"):
        tk.plan_bwd(86, 112, 160, FULL, *H100, candidate=("resident", 2))


def test_plan_reads_from_l2_where_the_slices_do_not_fit():
    """On 64 SMs the full-width slices (twice a CTA's share on 132) fit no
    CTA's shared memory: the plan reads them from the workspace copy."""
    p = _check_plan(86, 112, 160, FULL, 64, H100[1])
    assert tk.MODES[p.mode] == "l2"


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 700), B=st.integers(1, 128), T=st.integers(1, 256),
       sm_count=st.integers(1, 160), smem_kb=st.integers(16, 227))
def test_plan_property(n, B, T, sm_count, smem_kb):
    try:
        _check_plan(n, B, T, FULL, sm_count, smem_kb * 1024)
    except ValueError as e:
        assert f"past the limit of {smem_kb * 1024}" in str(e)


def test_profile_tacotron_train_variants_match_the_kernel_source():
    """``profile_tacotron_train`` makes its variants by replacing parts of
    ``csrc/tacotron_train.cu`` with ``csrc/common.cuh`` written into it:
    every part it names must still be there, and every variant must differ
    from the source and from the others."""
    from rtvc_tpu_torch import profile_lstm
    from rtvc_tpu_torch import profile_tacotron_train as pt

    source = profile_lstm.flat_source("tacotron_train.cu")
    made = pt.variants(source)
    assert set(made) == {"base", "no_wait", "no_loads", "phases"}
    assert made["base"] == source and len({*made.values()}) == len(made)
    assert pt.INPUT_LOAD not in made["no_loads"]
    assert profile_lstm.BARRIER_WAIT not in made["no_wait"]
    with pytest.raises(RuntimeError, match="no longer holds"):
        pt.variants(source.replace(pt.INPUT_LOAD, ""))
