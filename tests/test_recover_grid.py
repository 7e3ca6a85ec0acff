"""recover_grid: factoring a bare pair list into a (slot x col) grid."""

import numpy as np

from tfqmrgpu_tpu.io import planfile as rt


def _banded_pairs(mb=24, ncols=3, deg=3):
    """Synthesize a grid-dense banded pair list (like the bench fallback)."""
    rowptr_a = np.arange(mb + 1) * deg
    colind_a = ((np.arange(mb)[:, None] + np.arange(deg)[None, :]) % mb
                ).reshape(-1)
    xid = np.arange(mb * ncols).reshape(mb, ncols)
    pa, px, py = [], [], []
    for r in range(mb):
        for c in range(ncols):
            for ia in range(rowptr_a[r], rowptr_a[r + 1]):
                pa.append(ia)
                px.append(xid[colind_a[ia], c])
                py.append(xid[r, c])
    return (np.asarray(pa), np.asarray(px), np.asarray(py),
            mb * ncols, mb * deg)


def _grid_multiply(g, a, x, lm, ln, nnzb):
    """Reference evaluation of the grid factorization (scalar blocks ok)."""
    xg = np.zeros((g.nslots, g.ncols, lm, ln))
    xg[g.slot_of, g.col_of] = x
    yg = np.zeros((g.nslots, g.ncols, lm, ln))
    for s in range(g.nslots):
        for jj in range(g.rowptr[s], g.rowptr[s + 1]):
            k = g.colind[jj]
            yg[s] += np.einsum("ij,cjk->cik", a[g.a_order[jj]], xg[k])
    return yg[g.slot_of, g.col_of]


def test_recover_grid_exact_multiply(rng):
    pa, px, py, nnzb, nnzb_a = _banded_pairs()
    g = rt.recover_grid(pa, px, py, nnzb)
    assert g.ncols == 3
    # grid-dense pattern: fragments are full rows -> density 1
    assert g.nslots * g.ncols == nnzb
    lm, ln = 2, 2
    a = rng.standard_normal((nnzb_a, lm, lm))
    x = rng.standard_normal((nnzb, lm, ln))
    y_ref = np.zeros((nnzb, lm, ln))
    np.add.at(y_ref, py, np.matmul(a[pa], x[px]))
    y_got = _grid_multiply(g, a, x, lm, ln, nnzb)
    np.testing.assert_allclose(y_got, y_ref, atol=1e-12)


def test_recover_grid_ignores_unused_a_ids(rng):
    """Plan files carry A ids that appear in no pair (the golden plan has
    256 of them); they must not be materialized anywhere."""
    pa, px, py, nnzb, nnzb_a = _banded_pairs(mb=12, ncols=2, deg=3)
    pa = pa + 5                       # ids 0..4 now unused, max id shifts
    g = rt.recover_grid(pa, px, py, nnzb)
    assert g.a_order.min() >= 5
    assert np.unique(g.a_order).size == g.a_order.size
    lm, ln = 2, 2
    a = rng.standard_normal((nnzb_a + 5, lm, lm))
    x = rng.standard_normal((nnzb, lm, ln))
    y_ref = np.zeros((nnzb, lm, ln))
    np.add.at(y_ref, py, np.matmul(a[pa], x[px]))
    y_got = _grid_multiply(g, a, x, lm, ln, nnzb)
    np.testing.assert_allclose(y_got, y_ref, atol=1e-12)
