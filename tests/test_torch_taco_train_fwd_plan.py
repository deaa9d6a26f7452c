"""The partition of K5's forward (the Tacotron teacher-forced chain) over
the card: ``ops/tacotron_train.py:plan_fwd`` is pure, so no card is needed.
A plan must give every unit of every cut (so every output column of every
product), every (row, character) pair and every context item to exactly one
CTA for each batch row, keep a unit's gate rows in one CTA, lay out a CTA's
shared memory without overlaps inside the limit, and lay out the workspace;
or refuse with a ValueError that names the limit."""
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


def _items(p, B, T, E, cta):
    """The context items (row, column block) of CTA ``cta``, as the kernel
    deals them: item k of row b goes with pair (b, k·T // blocks)."""
    nblk = -(-E // tk.CTX_COLS)
    pairs = p.owned("pair", B * T, cta)
    rows = range(pairs.start // T, (pairs.stop - 1) // T + 1) if pairs else range(0)
    return [(b, k) for b in rows for k in range(nblk) if b * T + k * T // nblk in pairs]


def _regions(p, dims, T):
    """Every shared-memory region of the plan as (name, start, floats,
    phase): phase is the phase whose products' sums share it, else None."""
    D, L, E, KS = dims
    sm = dict(zip(tk.FWD_SMEM_SLOTS, p.sm))
    q = dict(zip(tk.FWD_CUTS, p.q))
    regions = []
    for k, (name, (cut, gates, n, phase, read)) in enumerate(tk.fwd_products(D, L, E).items()):
        if tk.MODES[p.mode] != "l2":
            regions.append((f"w:{name}", p.w_off[k], gates * q[cut] * _al4(n), None))
        regions.append((f"out:{name}", p.out_off[k], p.ks[k] * gates * q[cut] * p.rows,
                        phase if read == phase else None))
    for slot, cut in tk.FWD_STATE:
        regions.append((slot, sm[slot], q[cut] * p.rows, None))
    regions += [("scratch", sm["scratch"], tk.WARPS * -(-tk.ROWS * tk.NB // 32) * 32, None),
                ("rowbuf", sm["rowbuf"], sm["soft_rows"] * sm["row_stride"], None),
                ("wpart", sm["wpart"], max(2 * tk.WARPS * 32 + _al4(q["pair"]), 4 * tk.THREADS),
                 None)]
    return regions


def _check_plan(n, B, T, dims, sm_count, smem_limit, **kw):
    D, L, E, KS = dims
    p = tk.plan_fwd(n, B, T, dims, sm_count, smem_limit, **kw)
    assert isinstance(p, tk.FwdPlan)
    mode = tk.MODES[p.mode]
    assert 1 <= p.ctas <= sm_count and p.ctas % p.groups == 0
    assert len(p.ints()) == 5 + len(tk.FWD_CUTS) + 3 * len(tk.FWD_PRODUCTS) \
        + len(tk.FWD_SMEM_SLOTS) + len(tk.FWD_WS_SLOTS)
    # every batch row in exactly one group
    assert sorted(b for g in range(p.groups) for b in p.batch_rows(B, g)) == list(range(B))
    # every unit of the attention and LSTM cuts (so every output column of
    # every product) owned exactly once for each batch row: the CTAs of one
    # group cover the cut
    for cut, size in (("att", D), ("lstm", L)):
        for g in range(p.groups):
            owned = sorted(u for c in range(g, p.ctas, p.groups) for u in p.owned(cut, size, c))
            assert owned == list(range(size)), (cut, g)
    pairs = sorted(u for c in range(p.ctas) for u in p.owned("pair", B * T, c))
    assert pairs == list(range(B * T))
    # every context item owned once, by a CTA whose pairs' rows hold its row
    sm = dict(zip(tk.FWD_SMEM_SLOTS, p.sm))
    nblk = -(-E // tk.CTX_COLS)
    items = []
    for c in range(p.ctas):
        mine = _items(p, B, T, E, c)
        rows = {u // T for u in p.owned("pair", B * T, c)}
        assert all(b in rows for b, _ in mine)
        if rows:
            assert max(rows) - min(rows) + 1 <= sm["soft_rows"]
        items += mine
    assert sorted(items) == [(b, k) for b in range(B) for k in range(nblk)]
    # a unit's gate rows are the rows g·q + j of one CTA's slice (the 3 gate
    # columns of the GRU's matrices, the 4 of each LSTM matrix): the slices
    # lie one after another, gates x units of the slice each
    prods = tk.fwd_products(D, L, E)
    q = dict(zip(tk.FWD_CUTS, p.q))
    sizes = [gates * q[cut] * _al4(k) for cut, gates, k, _, _ in prods.values()]
    assert list(p.w_off) == [p.w_off[0] + sum(sizes[:i]) for i in range(len(sizes))]
    assert {cut for cut, *_ in prods.values()} == {"att", "lstm"}
    assert sm["row_stride"] == tk.fwd_row_stride(T, D) >= _al4(T + 2 * tk.MAX_TAPS) + _al4(D)
    # reduction pieces of whole chunks of 128 floats, none empty
    for i, (cut, gates, n_red, _, _) in enumerate(prods.values()):
        chunks = -(-n_red // tk.CHUNK)
        assert 1 <= p.ks[i] <= chunks and (p.ks[i] - 1) * -(-chunks // p.ks[i]) < chunks
    # shared memory: no overlaps but products' sums of different phases (the
    # sums a later phase reads keep their own), all inside [HEADER, end),
    # within the limit
    regions = _regions(p, dims, T)
    for i, (n1, a1, l1, ph1) in enumerate(regions):
        assert a1 % 4 == 0 and a1 >= tk.HEADER and a1 + l1 <= sm["end"], n1
        for n2, a2, l2, ph2 in regions[i + 1:]:
            if ph1 is not None and ph2 is not None and ph1 != ph2:
                continue
            if l1 and l2:
                assert a1 + l1 <= a2 or a2 + l2 <= a1, (n1, n2)
    assert p.smem == 4 * sm["end"] <= smem_limit
    # the state the kernel zeroes at the start is one run from ah to the
    # shared sums, and the kept sums lie inside it
    assert sm["ah"] < sm["x1"] < sm["outs"]
    for k, (cut, gates, _, ph, read) in enumerate(prods.values()):
        if read != ph:
            assert sm["x1"] < p.out_off[k] < sm["outs"]
    # the workspace: the barrier's 32 words, then each buffer in order
    ws = dict(zip(tk.FWD_WS_SLOTS, p.ws))
    assert ws["q"] == 32 and list(p.ws) == sorted(p.ws)
    assert ws["x1"] + B * _al4(L) == ws["wl2"]
    assert ws["total"] - ws["wl2"] == (p.ctas * sum(sizes) if mode == "l2" else 0)
    assert p.cost_ms > 0
    return p


@pytest.mark.parametrize("n,B", [(86, 112), (602, 22)])
def test_fwd_plan_takes_the_named_shapes(n, B):
    """The first session of the schedule (B 112 x 86 steps) and the last
    (B 22 x 602), T 160 at the full widths on an H100: 132 CTAs, the weight
    slices resident in shared memory, a CTA owning 2 attention units and 4
    LSTM units."""
    p = _check_plan(n, B, 160, FULL, *H100)
    assert p.ctas == 132 and p.name == "resident x1" and p.smem <= H100[1]
    assert dict(zip(tk.FWD_CUTS, p.q))["att"] == 2 and dict(zip(tk.FWD_CUTS, p.q))["lstm"] == 4


@pytest.mark.parametrize("candidate", tk.CANDIDATES)
@pytest.mark.parametrize("n,B", [(86, 112), (602, 22)])
def test_fwd_plan_forced_candidates_at_the_named_shapes(candidate, n, B):
    """Every candidate plans at both shapes when forced (the profile and the
    chip smoke time them), and costs no less than the plan's choice."""
    p = _check_plan(n, B, 160, FULL, *H100, candidate=candidate)
    assert (tk.MODES[p.mode], p.groups) == candidate
    assert tk.plan_fwd(n, B, 160, FULL, *H100).cost_ms <= p.cost_ms


@pytest.mark.parametrize("dims", [SMALL, ODD])
@pytest.mark.parametrize("sm_count", [1, 3, 16, 132])
@pytest.mark.parametrize("candidate", tk.CANDIDATES)
def test_fwd_plan_forced_candidates_narrow(dims, sm_count, candidate):
    """Each forced candidate plans at narrow and odd widths on cards of any
    size (a card too small for its groups refuses)."""
    try:
        p = _check_plan(4, 5, 9, dims, sm_count, H100[1], candidate=candidate)
    except ValueError:
        assert sm_count < candidate[1]
        return
    assert (tk.MODES[p.mode], p.groups) == candidate


# one character, fewer characters than a row's context items, a conv's
# width, the named length, the last session's longest, and past resident
@pytest.mark.parametrize("T", [1, 5, 31, 160, 601, 999, 1000])
def test_fwd_plan_text_lengths(T):
    """At batch 112 on an H100 the plan holds for any text length; the
    slices stay resident to T_text 999, then come from L2."""
    p = _check_plan(86, 112, T, FULL, *H100)
    assert (p.name == "resident x1") == (T <= 999)


def test_fwd_plan_names_the_limit():
    with pytest.raises(ValueError, match="past the limit of 4096"):
        tk.plan_fwd(86, 112, 160, FULL, 132, 4096)
    with pytest.raises(ValueError, match=r"resident x1 needs \d+"):
        tk.plan_fwd(86, 112, 160, FULL, 4, H100[1], candidate=("resident", 1))
    with pytest.raises(ValueError, match="at most 31"):
        tk.plan_fwd(86, 112, 160, (256, 512, 896, 33), *H100)
    with pytest.raises(ValueError, match="odd"):
        tk.plan_fwd(86, 112, 160, (256, 512, 896, 30), *H100)
    with pytest.raises(ValueError, match="bad plan inputs"):
        tk.plan_fwd(86, 0, 160, FULL, *H100)
    with pytest.raises(ValueError, match="not one of"):
        tk.plan_fwd(86, 112, 160, FULL, *H100, candidate=("cluster", 2))
    with pytest.raises(ValueError, match="fewer than 2 CTAs"):
        tk.plan_fwd(86, 112, 160, FULL, 1, H100[1], candidate=("l2", 2))


def test_fwd_plan_reads_from_l2_where_the_slices_do_not_fit():
    """On 64 SMs the full-width slices (twice a CTA's share on 132) fit no
    CTA's shared memory: the plan reads them from the workspace copy."""
    p = _check_plan(86, 112, 160, FULL, 64, H100[1])
    assert tk.MODES[p.mode] == "l2"


def test_fwd_and_bwd_share_the_candidates():
    """One candidate list and one mode enum for both directions: each
    forced candidate plans in both, under the same name."""
    for c in tk.CANDIDATES:
        f = tk.plan_fwd(86, 112, 160, FULL, *H100, candidate=c)
        b = tk.plan_bwd(86, 112, 160, FULL, *H100, candidate=c)
        assert f.name == b.name == f"{c[0]} x{c[1]}" and f.mode == b.mode


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 700), B=st.integers(1, 128), T=st.integers(1, 256),
       sm_count=st.integers(1, 160), smem_kb=st.integers(16, 227))
def test_fwd_plan_property(n, B, T, sm_count, smem_kb):
    try:
        _check_plan(n, B, T, FULL, sm_count, smem_kb * 1024)
    except ValueError as e:
        assert f"past the limit of {smem_kb * 1024}" in str(e)


def test_profile_tacotron_train_forward_variants_match_the_kernel_source():
    """``profile_tacotron_train``'s variants of ``csrc/tacotron_train.cu``
    reach the forward: its step loop gets a clock, its seven barriers are
    timed beside the backward's eight, and a source without the forward's
    loop refuses."""
    from rtvc_tpu_torch import profile_lstm
    from rtvc_tpu_torch import profile_tacotron_train as pt

    source = profile_lstm.flat_source("tacotron_train.cu")
    assert source.count(pt.BARRIER) == len(tk.FWD_PHASES) + len(tk.BWD_PHASES)
    made = pt.variants(source)
    assert made["phases"].count("long long t_last = clock64();") == 2
    assert made["phases"].count(pt.TIMED_BARRIER) == len(tk.FWD_PHASES) + len(tk.BWD_PHASES)
    assert pt.PHASES == {"fwd": tk.FWD_PHASES, "bwd": tk.BWD_PHASES}
    fwd_part = made["phases"].split("namespace fwd {")[1].split("namespace bwd {")[0]
    assert fwd_part.count(pt.TIMED_BARRIER) == len(tk.FWD_PHASES)
    assert "constexpr int kPhases = 7;" in fwd_part
    with pytest.raises(RuntimeError, match="no longer holds"):
        pt.variants(source.replace(pt.LOOP_STARTS[0], "  for (int s = 0; s != n; ++s) {\n"))
