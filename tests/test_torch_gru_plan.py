"""The partitions of K4 (GRU sequence) and K1 (WaveRNN sample loop) over the
card: ``ops/gru_seq.py:plan`` and ``ops/wavernn_generate.py:plan`` are pure,
so no card is needed. Each plan must cover every (row, unit) or (fold,
layer row) exactly once with CTAs that are all resident at once and fit
their shared memory, or refuse with a ValueError that names the limit."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtvc_tpu_torch.ops import gru_seq as gs
from rtvc_tpu_torch.ops import wavernn_generate as wg

H100 = (132, 232448)  # SMs, bytes of shared memory a block may opt in to


def _check_cooperative_plan(p, B, H, sm_count, smem_limit, backward, elem=4):
    # every hidden unit in exactly one slice, every batch row in exactly one group
    units = [u for s in range(p.slices) for u in range(s * p.units, min((s + 1) * p.units, H))]
    assert units == list(range(H))
    rows = [b for g in range(p.groups) for b in range(g * p.rows, min((g + 1) * p.rows, B))]
    assert rows == list(range(B))
    assert (p.groups - 1) * p.rows < B  # no empty group
    # all CTAs resident at once, one a SM, within its shared memory
    assert 1 <= p.groups * p.slices <= sm_count
    assert 0 < p.smem <= smem_limit
    w_rows, ld = (p.units, 3 * H) if backward else (3 * p.units, -(-H // 4) * 4)
    assert p.smem >= elem * w_rows * ld
    # an instantiation the kernels have
    assert p.nb in (gs.BWD_SLICES if backward else gs.FWD_SLICES)[p.units]
    # the least modelled cost of every candidate
    assert gs.cost(p, H, backward) == min(gs.cost(c, H, backward)
                                          for c in gs.candidates(B, H, sm_count, smem_limit,
                                                                 backward, elem))


def _check_row_plan(p, B, H, sm_count, smem_limit, backward, elem=4):
    # every batch row in exactly one cluster (or CTA), one cluster a row; the
    # clusters share nothing, so they need not all be resident at once
    assert 1 <= p.cluster <= 2 and p.ctas == B * p.cluster
    # every unit in exactly one CTA of the cluster, its lanes filling whole
    # warps, plus the producer warp; the lanes of a unit cover H
    units = gs.row_units(H, p.lanes, p.cluster)
    assert units * p.cluster >= H and (units - 32 // p.lanes) * p.cluster < H
    assert p.threads == units * p.lanes + 32 and (p.threads - 32) % 32 == 0
    assert 4 * p.lanes * p.chunks >= H and H <= gs.ROW_WIDEST
    kind = (p.lanes, p.chunks, p.cluster)
    assert kind in gs.ROW_KINDS
    # the lanes hold the whole W_hh in registers; the input ring and the
    # state of the row fit each CTA's shared memory
    assert 12 * p.chunks * p.lanes * units * p.cluster >= 3 * H * H
    assert p.smem == gs.row_smem(H, p.lanes, p.chunks, backward, elem)
    assert 0 < p.smem <= smem_limit
    ring = gs.ROW_RING * (6 if backward else 3) * H * elem
    state = 2 * 4 * (3 if backward else 1) * H
    assert p.smem >= ring + state
    # the first kind that covers H: one CTA to H 64, a cluster of two past it
    assert kind == next(k for k in gs.ROW_KINDS if 4 * k[0] * k[1] >= H)
    assert p.cluster == (1 if H <= 64 else 2)


def _check_gru_plan(B, H, sm_count, smem_limit, backward, elem=4):
    p = gs.plan(B, H, sm_count, smem_limit, backward, elem)
    if isinstance(p, gs.RowPlan):
        _check_row_plan(p, B, H, sm_count, smem_limit, backward, elem)
    else:
        # the cooperative plan wherever no row-resident plan fits
        assert gs.row_plan(B, H, smem_limit, backward, elem) is None
        assert p == gs.cooperative_plan(B, H, sm_count, smem_limit, backward, elem)
        _check_cooperative_plan(p, B, H, sm_count, smem_limit, backward, elem)
    return p


def _check_gru_plan_or_limit(B, H, sm_count, smem_limit, backward):
    try:
        _check_gru_plan(B, H, sm_count, smem_limit, backward)
    except ValueError as e:
        assert "past the limit of" in str(e)
        assert H > int(str(e).split("past the limit of ")[1].split()[0])
    # the cooperative design keeps its own contract at every width, the
    # narrow ones included (chip_smoke.py and profile_gru reach it there
    # through an explicit plan vector)
    try:
        p = gs.cooperative_plan(B, H, sm_count, smem_limit, backward)
    except ValueError as e:
        assert H > int(str(e).split("past the limit of ")[1].split()[0])
    else:
        _check_cooperative_plan(p, B, H, sm_count, smem_limit, backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sm_count", [16, 108, 132, 144])
@pytest.mark.parametrize("B,H", [(1, 13), (2, 40), (40, 256), (40, 512), (112, 64), (133, 200),
                                 (640, 256), (1, 1056), (5, 6), (1000, 1)])
def test_gru_plan_covers_the_shape(B, H, sm_count, backward):
    _check_gru_plan_or_limit(B, H, sm_count, H100[1], backward)
    if H <= sm_count:  # one unit a CTA fits any card
        _check_gru_plan(B, H, sm_count, H100[1], backward)


def test_gru_plan_at_the_wavernn_training_shapes():
    """The three WaveRNN training shapes on an H100: two batch groups where
    they halve what each CTA reads from L2, three rows a warp pass; and the
    CBHG BiGRU's width at the Tacotron batch, row-resident: 112 CTAs of one
    row, 2 lanes a unit."""
    got = {(B, H, bw): tuple(_check_gru_plan(B, H, *H100, bw)[:5])
           for B, H in ((40, 256), (40, 512), (112, 64)) for bw in (False, True)}
    assert got[(40, 256, False)] == (2, 64, 4, 3, 20)
    assert got[(40, 256, True)] == (4, 32, 8, 3, 10)
    assert got[(40, 512, False)] == (2, 64, 8, 3, 20)
    assert got[(40, 512, True)] == (2, 64, 8, 3, 20)
    for bw in (False, True):
        p = gs.plan(112, 64, *H100, bw)
        assert isinstance(p, gs.RowPlan) and p[:5] == (112, 2, 8, 1, 160)


@pytest.mark.parametrize("H", [64, 128, 256])
def test_gru_plan_at_one_row(H):
    """B 1 (ForwardTacotron's BiGRUs, the Tacotron clone's CBHGs): row-resident
    with W_hh in registers, at H 64 one CTA of 2 lanes a unit, at H 128 a
    cluster of two CTAs of 4 lanes a unit, 64 units each; at H 256 the
    cooperative plan of 4 units a CTA, one row a pass.
    That cooperative plan is the fastest of its mode on an H100 at H 64, 128
    and 256 alike; a warp pass of fewer than 12 sums (units 1-2, nb 1) is
    slow there."""
    p = _check_gru_plan(1, H, *H100, False)
    coop = gs.cooperative_plan(1, H, *H100)
    assert tuple(coop[:5]) == (1, H // 4, 4, 1, 1)
    if H <= 128:
        assert isinstance(p, gs.RowPlan)
        assert p[:5] == ((1, 2, 8, 1, 160) if H == 64 else (2, 4, 8, 2, 288))
    else:
        assert p == coop
    slow = gs.Plan(1, H, 1, 1, 1, gs._smem(H, 1, 1, False))
    assert gs.cost(slow, H, False) > gs.cost(coop, H, False) + gs.SMALL_PASS_CYCLES / 2


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", [1, 8, 16, 56, 112, 133, 600])
@pytest.mark.parametrize("H", [1, 13, 40, 64, 65, 100, 128])
def test_gru_plan_row_resident_on_an_h100(H, B, backward, elem):
    """On an H100 every H <= 128 is row-resident in both stream dtypes (past
    H 64 in clusters of two), one cluster a batch row past the SMs too; and
    one width past it is cooperative."""
    p = _check_gru_plan(B, H, *H100, backward, elem)
    assert isinstance(p, gs.RowPlan) and p.ctas == B * (1 if H <= 64 else 2)
    assert isinstance(_check_gru_plan(B, 256, *H100, backward, elem), gs.Plan)


@pytest.mark.parametrize("backward", [False, True])
def test_gru_plan_names_the_limit(backward):
    _check_gru_plan(4, 1056, *H100, backward)   # 8 units on each of 132 SMs
    with pytest.raises(ValueError, match="past the limit of 1056 for 132 SMs"):
        gs.plan(4, 1057, *H100, backward=backward)
    # a card with little shared memory is bounded by that, not by its SMs
    with pytest.raises(ValueError, match="past the limit of"):
        gs.plan(4, 1024, 132, 48 * 1024, backward=backward)
    _check_gru_plan(4, 256, 132, 48 * 1024, backward)
    with pytest.raises(ValueError, match="must be positive"):
        gs.plan(0, 256, *H100, backward=backward)


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 2048), H=st.integers(1, 1200), sm_count=st.integers(1, 200),
       smem_kb=st.integers(16, 256), backward=st.booleans())
def test_gru_plan_property(B, H, sm_count, smem_kb, backward):
    _check_gru_plan_or_limit(B, H, sm_count, smem_kb * 1024, backward)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

# (variant, R, F, C, head) of the seven cells at their default widths
CELLS = [(wg.VOC_FATCHORD, 512, 512, 1024, wg.HEAD_CATEGORICAL),
         (wg.VOC_FATCHORD, 512, 512, 30, wg.HEAD_MOL),
         (wg.VOC_GENEING, 256, 128, 1024, wg.HEAD_CATEGORICAL),
         (wg.VOC_GENEING, 256, 128, 2, wg.HEAD_BETA),
         (wg.VOC_GENEING, 256, 128, 30, wg.HEAD_MOL),
         (wg.VOC_RUNTIMERACER, 256, 256, 1024, wg.HEAD_CATEGORICAL),
         (wg.VOC_RUNTIMERACER, 256, 256, 30, wg.HEAD_MOL)]


def _owned(n, q, ctas):
    """The rows [0, n) as the CTAs own them, q a CTA, in CTA order."""
    return [r for c in range(ctas) for r in range(c * q, min((c + 1) * q, n))]


def _check_k1_plan(variant, R, F, C, head, B, sm_count, smem_limit):
    p = wg.plan(variant, R, F, C, B, sm_count, smem_limit, head=head)
    assert 1 <= p.ctas <= sm_count
    # every GRU unit and every row of every FC in exactly one CTA
    assert _owned(R, p.units, p.ctas) == list(range(R))
    assert _owned(F, p.fc_rows, p.ctas) == list(range(F))
    assert _owned(C, p.last_rows, p.ctas) == list(range(C))
    if head == wg.HEAD_CATEGORICAL:
        assert p.last_rows % 4 == 0  # a CTA's classes are whole Philox draws
    # every fold in exactly one fold block of every layer
    assert p.nb in wg.FOLD_PASSES and p.fb % p.nb == 0
    blocks = [f for f0 in range(0, B, p.fb) for f in range(f0, min(f0 + p.fb, B))]
    assert blocks == list(range(B))
    assert 0 < p.smem <= smem_limit
    assert p.smem == wg._smem_bytes(variant, R, F, head, B, p.units, p.fc_rows,
                                    p.last_rows, p.nb, p.fb)
    return p


@pytest.mark.parametrize("B", [1, 8, 13, 39, 132, 264, 1000])
@pytest.mark.parametrize("variant,R,F,C,head", CELLS)
def test_k1_plan_fits_the_cells(variant, R, F, C, head, B):
    """All seven cells at their default widths on an H100, from one fold to
    the batched vocode's 39 and past the SM count."""
    p = _check_k1_plan(variant, R, F, C, head, B, *H100)
    assert p.ctas == 128  # R 256 or 512 and C 1024 cut evenly: 4 of 132 SMs idle
    assert p.nb == (8 if B >= wg.WIDE_FOLDS else 4)


def test_k1_plan_at_the_clone_shape():
    """runtimeracer RAW at the 5 s clone's 13 folds: 2 units of each GRU, 2
    rows of each FC and 8 classes a CTA, the 13 folds in one block."""
    p = _check_k1_plan(wg.VOC_RUNTIMERACER, 256, 256, 1024, wg.HEAD_CATEGORICAL, 13, *H100)
    assert tuple(p[:6]) == (128, 2, 2, 8, 4, 16)


def test_k1_plan_names_the_limit():
    with pytest.raises(ValueError, match="past the limit of 232448"):
        wg.plan(wg.VOC_FATCHORD, 1024, 1024, 1024, 8, *H100)
    with pytest.raises(ValueError, match="past the limit of 48000"):
        wg.plan(wg.VOC_RUNTIMERACER, 256, 256, 1024, 8, 132, 48000)
    limit = 48000 + 4 * 4096
    p = wg.plan(wg.VOC_GENEING, 256, 128, 1024, 4000, 132, limit)
    assert p.smem <= limit
    with pytest.raises(ValueError, match="folds are past the limit of"):
        wg.plan(wg.VOC_GENEING, 256, 128, 1024, 200000, 132, limit)
    with pytest.raises(ValueError, match="bad plan inputs"):
        wg.plan(wg.VOC_GENEING, 256, 128, 1024, 0, *H100)


@settings(max_examples=200, deadline=None)
@given(cell=st.sampled_from(CELLS), B=st.integers(1, 3000), sm_count=st.integers(8, 200),
       smem_kb=st.integers(32, 256), scale=st.sampled_from([0.25, 0.5, 1, 2]))
def test_k1_plan_property(cell, B, sm_count, smem_kb, scale):
    variant, R, F, C, head = cell
    R, F = max(4, int(R * scale)), max(4, int(F * scale))
    try:
        _check_k1_plan(variant, R, F, C, head, B, sm_count, smem_kb * 1024)
    except ValueError as e:
        assert "past the limit of" in str(e)


@pytest.mark.parametrize("source", ["gru_seq.cu", "wavernn_generate.cu"])
def test_profile_variants_match_the_kernel_sources(source):
    """``profile_gru`` and ``profile_wavernn`` make their variants by
    replacing parts of the kernel's source with ``common.cuh`` written into
    it: every part they name must still be there, and every variant must
    differ from the source and from the others."""
    from rtvc_tpu_torch import profile_gru, profile_lstm

    text = profile_lstm.flat_source(source)
    made = profile_gru.variants(text)
    assert set(made) == {"base", "no_loads", "no_weights", "no_loads_no_weights", "no_wait"}
    assert made["base"] == text and len({*made.values()}) == len(made)
    assert profile_lstm.BARRIER_WAIT not in made["no_wait"]
    assert profile_lstm.WEIGHT_LOAD not in made["no_loads_no_weights"]


def test_profile_wavernn_clock_marks_match_the_kernel_source():
    """``profile_wavernn``'s clock build finds every mark it names in K1's
    source (``replaced`` raises where one is gone): each phase's sum once,
    the GRUs' before the FCs', and CTA 0's sums written where its samples
    go."""
    from rtvc_tpu_torch import profile_lstm, profile_wavernn

    text = profile_lstm.flat_source("wavernn_generate.cu")
    made = profile_wavernn.clocked(text)
    sums = [made.index(f"cyc[{i}] += c - c0") for i in range(len(profile_wavernn.PHASES))]
    assert sums == sorted(sums)
    assert all(made.count(f"cyc[{i}] +=") == 1 for i in range(len(sums)))
    assert "out[i] = (float)cyc[i]" in made and "cyc[" not in text


def test_profile_row_variants_match_the_kernel_source():
    """``profile_gru``'s row-resident variants (the forward without its xg
    ring, or without its product; both kernels clocked) replace parts of
    ``gru_seq.cu`` by their text: every part must still be there, and each
    variant must differ from the source and from the others. The
    smem_weights variant keeps no weights in registers and grows the shared
    memory the entry points check by the compute threads' weights."""
    from rtvc_tpu_torch import profile_gru, profile_lstm

    text = profile_lstm.flat_source("gru_seq.cu")
    made = profile_gru.row_variants(text)
    assert set(made) == {"base", "no_ring", "no_product", "smem_weights", "clock"}
    assert made["base"] == text and len({*made.values()}) == len(made)
    assert profile_gru.RING_READ not in made["no_ring"]
    assert profile_gru.PRODUCT not in made["no_product"]
    assert made["clock"].count("clock64()") == 2 * 6
    assert "float4 w[3][KI];" not in made["smem_weights"]
    assert made["smem_weights"].count("(size_t)12 * KI * nt") == 2
    p = gs.row_plan(1, 64, H100[1])
    assert profile_gru.smem_weights_plan(p).smem == p.smem + 3 * 64 * 64 * 4
