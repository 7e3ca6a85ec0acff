"""Plan/analysis-step tests: the vectorized builder must reproduce the
reference's pair/subset/colindx semantics exactly (oracle = direct
transcription of the host loops in tfqmrgpu.cu:183-339)."""

import numpy as np
import pytest

from tfqmrgpu_tpu.bsr import Bsr
from tfqmrgpu_tpu.errors import Status, TfqmrgpuError
from tfqmrgpu_tpu.plan import create_plan

from conftest import make_random_problem


def oracle_plan(a: Bsr, x: Bsr, b: Bsr, c0f1=0):
    """Direct nested-loop transcription of the reference analysis."""
    mb = a.nrows

    def find(lo, hi, val, arr):
        for i in range(lo, hi):
            if arr[i] == val:
                return i
        return -1

    pairs, starts = [], [0]
    rpA, ciA = a.rowptr - c0f1, a.colind
    rpX, ciX = x.rowptr - c0f1, x.colind
    rpB, ciB = b.rowptr - c0f1, b.colind
    for irow in range(mb):
        for inzy in range(rpX[irow], rpX[irow + 1]):
            jcol = ciX[inzy]
            for inza in range(rpA[irow], rpA[irow + 1]):
                k = ciA[inza] - c0f1
                inzx = find(rpX[k], rpX[k + 1], jcol, ciX)
                if inzx >= 0:
                    pairs.append((inza, inzx))
            starts.append(len(pairs))
    subset = []
    for irow in range(mb):
        for inzb in range(rpB[irow], rpB[irow + 1]):
            inzx = find(rpX[irow], rpX[irow + 1], ciB[inzb], ciX)
            assert inzx >= 0
            subset.append(inzx)
    # column compression on RAW indices
    raw = x.colind
    mn, mx = raw.min(), raw.max()
    occ = np.zeros(mx - mn + 1, bool)
    occ[raw - mn] = True
    trans = np.full(mx - mn + 1, -1)
    trans[occ] = np.arange(occ.sum())
    colindx = trans[raw - mn]
    return (np.array(pairs, dtype=np.uint32).reshape(-1, 2),
            np.array(starts, dtype=np.uint32),
            np.array(subset, dtype=np.uint32),
            colindx.astype(np.uint16))


@pytest.mark.parametrize("seed_shift", [0, 1, 2, 3])
def test_plan_matches_oracle(rng, seed_shift):
    a, x, b = make_random_problem(rng, mb=14, ncols=4, seed_shift=seed_shift)
    plan = create_plan(a, x, b)
    pairs_o, starts_o, subset_o, colindx_o = oracle_plan(a, x, b)
    np.testing.assert_array_equal(plan.pairs, pairs_o)
    np.testing.assert_array_equal(plan.starts, starts_o)
    np.testing.assert_array_equal(plan.subset, subset_o)
    np.testing.assert_array_equal(plan.colindx, colindx_o)
    assert plan.ncols == int(colindx_o.max()) + 1


def test_plan_fortran_offset(rng):
    a, x, b = make_random_problem(rng, mb=10, ncols=3)
    plan0 = create_plan(a, x, b)
    a1 = Bsr(a.nrows, a.ncols, a.rowptr + 1, a.colind + 1, a.data)
    x1 = Bsr(x.nrows, x.ncols, x.rowptr + 1, x.colind + 1, None)
    b1 = Bsr(b.nrows, b.ncols, b.rowptr + 1, b.colind + 1, b.data)
    plan1 = create_plan(a1, x1, b1, index_offset=1)
    np.testing.assert_array_equal(plan0.pairs, plan1.pairs)
    np.testing.assert_array_equal(plan0.subset, plan1.subset)
    np.testing.assert_array_equal(plan0.colindx, plan1.colindx)


def test_b_not_subset_raises(rng):
    # B with a block where X has none
    a, x, b = make_random_problem(rng, mb=8, ncols=2)
    # find a (row, col) where X is empty and put a B block there
    row_of_x = x.row_of()
    present = {(int(r), int(c)) for r, c in zip(row_of_x, x.colind)}
    bad = None
    for r in range(8):
        for c in range(2):
            if (r, c) not in present:
                bad = (r, c)
                break
        if bad:
            break
    assert bad is not None
    rowptr_b = np.zeros(9, np.int32)
    rowptr_b[bad[0] + 1:] = 1
    b_bad = Bsr(8, 2, rowptr_b, np.array([bad[1]]),
                np.zeros((1, 4, 8), complex))
    with pytest.raises(TfqmrgpuError) as ei:
        create_plan(a, x, b_bad)
    assert ei.value.code == int(Status.B_IS_NOT_SUBSET_OF_X)


def test_b_zero_column_raises(rng):
    a, x, b = make_random_problem(rng, mb=8, ncols=3)
    # remove all B blocks of column 2
    keep = b.colind != 2
    counts = np.bincount(b.row_of()[keep], minlength=8)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    b_bad = Bsr(8, 3, rowptr, b.colind[keep], b.data[keep])
    with pytest.raises(TfqmrgpuError) as ei:
        create_plan(a, x, b_bad)
    assert ei.value.code == int(Status.B_HAS_A_ZERO_COLUMN)


def test_empty_column_filtering():
    # X uses columns 0 and 5 only -> compressed to 2 columns
    a = Bsr(2, 2, [0, 2, 4], [0, 1, 0, 1],
            np.tile(np.eye(4)[None], (4, 1, 1)).astype(complex))
    x = Bsr(2, 6, [0, 2, 4], [0, 5, 0, 5], None)
    b = Bsr(2, 6, [0, 1, 2], [0, 5], np.ones((2, 4, 4), complex))
    plan = create_plan(a, x, b)
    assert plan.ncols == 2
    np.testing.assert_array_equal(plan.colindx, [0, 1, 0, 1])
    np.testing.assert_array_equal(plan.original_colind_x, [0, 5])


def test_reference_plan_file_counts():
    """Cross-check against the reference's golden SpMM plan asset (parsed
    read-only from the reference tree; skipped when unavailable)."""
    import os

    fn = "/root/reference/test/multiplication/plan_unordered.14-287-16"
    if not os.path.exists(fn):
        pytest.skip("reference plan file not mounted")
    from tfqmrgpu_tpu.io.planfile import read_plan_file

    pf = read_plan_file(fn)
    assert pf.nnzb_y == 4490 and pf.nnzb_a == 13109 and pf.nnzb_x == 4490
    assert pf.pairs.shape[0] == 50526
    assert pf.starts.shape[0] == 4491
