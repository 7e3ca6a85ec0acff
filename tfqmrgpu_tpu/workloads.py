"""Reference workloads shared by the benchmark and the GPU smoke check.

* ``synthesized_golden_pairs``: a banded multiplication plan of the golden
  plan's size.  The reference's ``plan_unordered.14-287-16`` (50,526 pairs)
  is not shipped with this repository; this plan has 281 block rows, 11 A
  blocks per row (circulant), 16 RHS block columns and 49,456 pairs.
* ``cos_sin_fill``: the reference bench's deterministic block data
  (fill_cos_sin, bench_tfqmrgpu.cu:276-287).
* ``pair_walk_reference``: the NumPy pair walk in complex128, the plain
  reference every SpMM engine is checked against (the reference bench's
  OpenMP CPU check, bench_tfqmrgpu.cu:353-419).
* ``banded_problem``: a diagonally dominant operator on the synthesized
  plan's pattern, with one B block per RHS block column.
"""

from __future__ import annotations

import numpy as np

from .bsr import Bsr

GOLDEN_MB, GOLDEN_NCOLS, GOLDEN_DEG = 281, 16, 11


def circulant_pattern(mb: int, deg: int):
    """(rowptr, colind) of the circulant band: row i holds block columns
    (i + s) % mb for s in 0..deg-1, sorted."""
    cols = np.sort((np.arange(mb)[:, None] + np.arange(deg)[None, :]) % mb,
                   axis=1)
    return np.arange(mb + 1) * deg, cols.reshape(-1)


def synthesized_golden_pairs(mb: int = GOLDEN_MB, ncols: int = GOLDEN_NCOLS,
                             deg: int = GOLDEN_DEG):
    """Pair list of ``Y = A @ X`` for a circulant band A and a full X grid
    of ``ncols`` block columns.  Returns (pair_a, pair_x, pair_y, nnzb_y,
    nnzb_a, nnzb_x); pair_y is sorted ascending."""
    rowptr, colind = circulant_pattern(mb, deg)
    nx = mb * ncols
    # X block of (row r, col c) is r * ncols + c; Y blocks follow X's order
    iy = np.arange(nx)
    r, c = iy // ncols, iy % ncols
    ia = rowptr[r][:, None] + np.arange(deg)[None, :]        # [nx, deg]
    pair_a = ia.reshape(-1)
    pair_x = (colind[ia] * ncols + c[:, None]).reshape(-1)
    pair_y = np.repeat(iy, deg)
    return (pair_a.astype(np.int64), pair_x.astype(np.int64),
            pair_y.astype(np.int64), nx, mb * deg, nx)


def cos_sin_fill(nnzb: int, d1: int, d2: int, dtype=np.float64):
    """re = cos(idx), im = sin(idx) with idx = (m*d1 + i)*d2 + j."""
    idx = np.arange(nnzb * d1 * d2, dtype=np.float64).reshape(nnzb, d1, d2)
    return np.cos(idx).astype(dtype), np.sin(idx).astype(dtype)


def pair_walk_reference(a: np.ndarray, x: np.ndarray, pair_a, pair_x,
                        pair_y, nnzb_y: int, chunk: int = 4096) -> np.ndarray:
    """Y = A @ X over a pair list in complex128 on the host.  ``a`` and
    ``x`` are complex block arrays [nnzb, d1, d2]; pairs are processed in
    chunks so the gathered operands stay small."""
    a = np.asarray(a, np.complex128)
    x = np.asarray(x, np.complex128)
    y = np.zeros((nnzb_y, a.shape[1], x.shape[2]), np.complex128)
    pair_a = np.asarray(pair_a, np.int64)
    pair_x = np.asarray(pair_x, np.int64)
    pair_y = np.asarray(pair_y, np.int64)
    for lo in range(0, pair_a.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        np.add.at(y, pair_y[sl], np.matmul(a[pair_a[sl]], x[pair_x[sl]]))
    return y


def plan_pair_y(plan) -> np.ndarray:
    """Per-pair Y block index of a Plan (pairs are grouped by Y block)."""
    return np.repeat(np.arange(plan.nnzb_x, dtype=np.int64),
                     np.diff(plan.starts).astype(np.int64))


def relative_residual(plan, a_data, x_data, b_data) -> float:
    """|A X - B| / |B| over X's pattern, by the NumPy pair walk."""
    ax = pair_walk_reference(a_data, x_data, plan.pairs[:, 0],
                             plan.pairs[:, 1], plan_pair_y(plan),
                             plan.nnzb_x)
    bx = np.zeros_like(ax)
    np.add.at(bx, plan.subset.astype(np.int64),
              np.asarray(b_data, np.complex128))
    return float(np.linalg.norm(ax - bx) / np.linalg.norm(bx))


def banded_problem(mb: int = GOLDEN_MB, ncols: int = GOLDEN_NCOLS,
                   lm: int = 32, ln: int = 32, deg: int = GOLDEN_DEG,
                   seed: int = 7, dtype=np.complex128):
    """Diagonally dominant complex operator on the circulant band, a full
    X grid of ``ncols`` block columns and one B block per column (column
    c's B block sits in block row c).  Returns (A, X, B) Bsr objects."""
    rng = np.random.default_rng(seed)
    rowptr, colind = circulant_pattern(mb, deg)
    a_data = (rng.standard_normal((colind.shape[0], lm, lm))
              + 1j * rng.standard_normal((colind.shape[0], lm, lm)))
    diag = rowptr[:-1] + np.argmax(
        colind.reshape(mb, deg) == np.arange(mb)[:, None], axis=1)
    a_data[diag] += 4.0 * deg * lm * np.eye(lm)
    a = Bsr(mb, mb, rowptr, colind, a_data.astype(dtype), name="A")
    x = Bsr(mb, ncols, np.arange(mb + 1) * ncols,
            np.tile(np.arange(ncols), mb), None, name="X")
    rowptr_b = np.minimum(np.arange(mb + 1), ncols)
    b_data = (rng.standard_normal((ncols, lm, ln))
              + 1j * rng.standard_normal((ncols, lm, ln)))
    b = Bsr(mb, ncols, rowptr_b, np.arange(ncols), b_data.astype(dtype),
            name="B")
    return a, x, b
