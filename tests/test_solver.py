"""End-to-end solver tests against dense direct solves."""

import numpy as np
import pytest

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu.errors import Status

from conftest import dense_from_bsr, make_random_problem


def dense_reference_x(a, x, b, lm, ln):
    """Solve the dense system and return the X blocks on X's pattern."""
    a_dense = dense_from_bsr(a, lm, lm)
    b_dense = dense_from_bsr(b, lm, ln)
    x_dense = np.linalg.solve(a_dense, b_dense)
    row_of_x = x.row_of()
    blocks = np.zeros((x.nnzb, lm, ln), complex)
    for inz in range(x.nnzb):
        r, c = int(row_of_x[inz]), int(x.colind[inz])
        blocks[inz] = x_dense[r * lm:(r + 1) * lm, c * ln:(c + 1) * ln]
    return blocks, x_dense


@pytest.mark.parametrize("precision,tol,atol", [("z", 1e-9, 1e-6),
                                                ("c", 1e-4, 2e-3)])
def test_solve_full_x_pattern(rng, precision, tol, atol):
    """With a FULL X pattern the iterate can represent the exact solution, so
    the converged X must match the dense solve."""
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=3, x_fill=1.0)
    x_blocks, info = tq.solve(a, x, b, precision=precision, tolerance=tol,
                              max_iterations=500)
    assert info.return_status == int(Status.SUCCESS)
    assert info.residuum_reached <= tol
    assert 0 < info.iterations_needed <= 500
    assert info.flops_performed > 0
    want, _ = dense_reference_x(a, x, b, lm, ln)
    np.testing.assert_allclose(x_blocks.data, want, atol=atol)


def test_solve_residual_definition(rng):
    """The reported residuum is max_col |A@X - B|_F / |B|_F on the pattern."""
    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0)
    xs, info = tq.solve(a, x, b, precision="z", tolerance=1e-8,
                        max_iterations=500)
    a_dense = dense_from_bsr(a, lm, lm)
    x_dense = dense_from_bsr(xs, lm, ln)
    b_dense = dense_from_bsr(b, lm, ln)
    r = a_dense @ x_dense - b_dense
    res_cols = np.linalg.norm(r.reshape(-1, 3, ln), axis=(0, 2)) \
        / np.linalg.norm(b_dense.reshape(-1, 3, ln), axis=(0, 2))
    assert res_cols.max() <= 1e-8 * 1.01


def test_solve_sparse_x_pattern(rng):
    """Sparse X pattern (truncated solve): residual restricted to the
    pattern still converges below tolerance."""
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=4,
                                  x_fill=0.7)
    xs, info = tq.solve(a, x, b, precision="z", tolerance=1e-7,
                        max_iterations=2000)
    assert info.return_status == int(Status.SUCCESS)
    assert info.residuum_reached <= 1e-7


def test_trivial_rhs(rng):
    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z")
    info = s.solve(tolerance=1e-8, max_iterations=500, rhs_trivial=True)
    assert info.return_status == int(Status.SUCCESS)
    got = s.get_matrix("X")
    # oracle: B = unit blocks scattered on B's pattern
    b_unit = np.zeros((b.nnzb, lm, ln), complex)
    for i in range(b.nnzb):
        for j in range(ln):
            b_unit[i, j % lm, j] = 1.0
    want, _ = dense_reference_x(a, x, b.with_data(b_unit), lm, ln)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_max_iterations_status(rng):
    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z")
    info = s.solve(tolerance=1e-30, max_iterations=3)
    assert info.return_status == int(Status.MAX_ITERATIONS)
    assert info.iterations_needed == 3


def test_get_matrix_layouts(rng):
    from tfqmrgpu_tpu.ops import layout as L

    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=6, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z")
    s.solve(tolerance=1e-8, max_iterations=300)
    xc = s.get_matrix("X")
    riri = s.get_matrix("X", layout=L.LAYOUT_RIRIRIRI)
    np.testing.assert_allclose(riri[..., 0], xc.real)
    np.testing.assert_allclose(riri[..., 1], xc.imag)
    xt = s.get_matrix("X", trans="t")
    np.testing.assert_allclose(xt, np.swapaxes(xc, 1, 2))


def test_solver_reuse_plan(rng):
    """Re-solving with a new B reuses the plan (flops accumulate)."""
    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z")
    i1 = s.solve(tolerance=1e-8, max_iterations=300)
    s.set_matrix("B", b.data * 2.0)
    i2 = s.solve(tolerance=1e-8, max_iterations=300)
    assert i2.flops_performed_all > i1.flops_performed
    assert i2.return_status == int(Status.SUCCESS)


def test_auto_engine_prefers_rowtile_for_sparse_c(rng):
    """A sparse banded 'c' problem too big for the 'dense' engine: on the
    CPU engine='auto' picks the XLA block-list engine (never an
    interpreted kernel), and solves correctly."""
    from tfqmrgpu_tpu.bsr import Bsr

    lm = ln = 8
    mb, deg, ncols = 600, 3, 2   # big enough that dense A (184 MB) is
    # rejected
    rng2 = np.random.default_rng(3)
    rowptr_a = np.arange(mb + 1, dtype=np.int32) * deg
    colind_a = ((np.arange(mb)[:, None] + np.arange(deg)[None, :] - 1)
                % mb).astype(np.int32)
    colind_a = np.sort(colind_a, axis=1).reshape(-1)
    a_data = (rng2.standard_normal((mb * deg, lm, lm))
              + 1j * rng2.standard_normal((mb * deg, lm, lm))
              ).astype(np.complex64)
    for i in range(mb):
        row = slice(rowptr_a[i], rowptr_a[i + 1])
        j = np.flatnonzero(colind_a[row] == i)[0] + rowptr_a[i]
        a_data[j] += 4.0 * deg * lm * np.eye(lm)
    a = Bsr(mb, mb, rowptr_a, colind_a, a_data, name="A")
    x = Bsr(mb, ncols, np.arange(mb + 1, dtype=np.int32) * ncols,
            np.tile(np.arange(ncols, dtype=np.int32), mb), name="X")
    rowptr_b = np.zeros(mb + 1, np.int32)
    rowptr_b[1: ncols + 1] = np.arange(1, ncols + 1)
    rowptr_b[ncols + 1:] = ncols
    b_data = (rng2.standard_normal((ncols, lm, ln))
              + 1j * rng2.standard_normal((ncols, lm, ln))
              ).astype(np.complex64)
    b = Bsr(mb, ncols, rowptr_b, np.arange(ncols, dtype=np.int32),
            b_data, name="B")

    from tfqmrgpu_tpu.solver import Solver

    s = Solver(a, x, b, precision="c", engine="auto")
    assert s.engine == "xla", s.engine
    info = s.solve(tolerance=1e-4, max_iterations=300)
    assert info.return_status == 0
    xd = dense_from_bsr(x.with_data(s.get_matrix("X")), lm, ln)
    ad = dense_from_bsr(a, lm, lm)
    bd = dense_from_bsr(b, lm, ln)
    assert np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd)) < 5e-3
