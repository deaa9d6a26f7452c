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


def _check_gru_plan(B, H, sm_count, smem_limit, backward):
    p = gs.plan(B, H, sm_count, smem_limit, backward)
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
    assert p.smem >= 4 * w_rows * ld
    # an instantiation the kernels have
    assert p.nb in (gs.BWD_SLICES if backward else gs.FWD_SLICES)[p.units]
    # the least modelled cost of every candidate
    assert gs.cost(p, H, backward) == min(gs.cost(c, H, backward)
                                          for c in gs.candidates(B, H, sm_count, smem_limit,
                                                                 backward))
    return p


def _check_gru_plan_or_limit(B, H, sm_count, smem_limit, backward):
    try:
        _check_gru_plan(B, H, sm_count, smem_limit, backward)
    except ValueError as e:
        assert "past the limit of" in str(e)
        assert H > int(str(e).split("past the limit of ")[1].split()[0])


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
    CBHG BiGRU's width at the Tacotron batch."""
    got = {(B, H, bw): tuple(_check_gru_plan(B, H, *H100, bw)[:5])
           for B, H in ((40, 256), (40, 512), (112, 64)) for bw in (False, True)}
    assert got[(40, 256, False)] == (2, 64, 4, 3, 20)
    assert got[(40, 256, True)] == (4, 32, 8, 3, 10)
    assert got[(40, 512, False)] == (2, 64, 8, 3, 20)
    assert got[(40, 512, True)] == (2, 64, 8, 3, 20)
    for bw in (False, True):
        p = got[(112, 64, bw)]
        assert p[0] * p[1] <= 132 and p[0] * p[4] >= 112


@pytest.mark.parametrize("H", [64, 128, 256])
def test_gru_plan_at_one_row(H):
    """B 1 (ForwardTacotron's BiGRUs, the Tacotron clone's CBHGs): 4 units a
    CTA, one row a pass, the fastest plan on an H100 at H 64, 128 and 256;
    a warp pass of fewer than 12 sums (units 1-2, nb 1) is slow there."""
    p = _check_gru_plan(1, H, *H100, False)
    assert tuple(p[:5]) == (1, H // 4, 4, 1, 1)
    slow = gs.Plan(1, H, 1, 1, 1, gs._smem(H, 1, 1, False))
    assert gs.cost(slow, H, False) > gs.cost(p, H, False) + gs.SMALL_PASS_CYCLES / 2


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
