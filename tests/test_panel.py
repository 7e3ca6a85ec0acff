"""Panel-engine tests: the dense engine must reproduce the block-list
engine's solutions and statistics."""

import numpy as np
import pytest

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu.errors import Status
from tfqmrgpu_tpu.ops.panel import PanelLayout
from tfqmrgpu_tpu.plan import create_plan

from conftest import dense_from_bsr, make_random_problem


def test_panel_layout_roundtrip(rng):
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                  x_fill=0.6)
    plan = create_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    lay = PanelLayout.from_plan(plan)
    blocks = rng.standard_normal((plan.nnzb_x, lm, ln))
    np.testing.assert_array_equal(lay.unpack_x(lay.pack_x(blocks)), blocks)
    # pack_b places B blocks at their X slots
    bb = rng.standard_normal((plan.nnzb_b, lm, ln))
    pb = lay.pack_b(bb)
    px = np.zeros((plan.nnzb_x, lm, ln))
    px[plan.subset] = bb
    np.testing.assert_array_equal(lay.unpack_x(pb), px)
    # mask covers exactly the X pattern
    assert lay.mask.sum() == plan.nnzb_x


def test_densify_a_matches_dense_assembly(rng):
    lm = 4
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=4, ncols=2,
                                  x_fill=1.0)
    plan = create_plan(a, x, b)
    plan.lm, plan.ln = lm, 4
    lay = PanelLayout.from_plan(plan)
    dr, di = lay.densify_a(plan, a.data.real.copy(), a.data.imag.copy())
    want = dense_from_bsr(a, lm, lm)
    np.testing.assert_allclose(dr + 1j * di, want)


@pytest.mark.parametrize("engine,prec", [("dense", "z"), ("dense", "c")])
def test_panel_engines_match_block_engine(rng, engine, prec):
    lm, ln = 4, 8
    dtype = np.complex64 if prec == "c" else np.complex128
    tol = 1e-5 if prec == "c" else 1e-9
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=4,
                                  x_fill=0.7, dtype=dtype)
    x1, i1 = tq.solve(a, x, b, precision=prec, engine="xla",
                      tolerance=tol, max_iterations=500)
    x2, i2 = tq.solve(a, x, b, precision=prec, engine=engine,
                      tolerance=tol, max_iterations=500)
    assert i2.return_status == int(Status.SUCCESS)
    # same shadow vector + same recurrence -> same iteration path
    assert i2.iterations_needed == i1.iterations_needed
    atol = 1e-3 if prec == "c" else 1e-9
    np.testing.assert_allclose(x2.data, x1.data, atol=atol)


def test_dense_engine_full_pattern_exact(rng):
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0)
    xs, info = tq.solve(a, x, b, precision="z", engine="dense",
                        tolerance=1e-10, max_iterations=500)
    a_dense = dense_from_bsr(a, lm, lm)
    b_dense = dense_from_bsr(b, lm, ln)
    x_dense = dense_from_bsr(xs, lm, ln)
    res = np.linalg.norm(a_dense @ x_dense - b_dense) \
        / np.linalg.norm(b_dense)
    assert res < 1e-8


def test_dense_engine_trivial_rhs(rng):
    lm, ln = 4, 4
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z", engine="dense")
    info = s.solve(tolerance=1e-8, max_iterations=500, rhs_trivial=True)
    assert info.return_status == int(Status.SUCCESS)
    sb = tq.Solver(a, x, b, precision="z", engine="xla")
    info_b = sb.solve(tolerance=1e-8, max_iterations=500, rhs_trivial=True)
    np.testing.assert_allclose(s.get_matrix("X"), sb.get_matrix("X"),
                               atol=1e-8)
    assert info.iterations_needed == info_b.iterations_needed


def test_auto_engine_picks_dense_for_small(rng):
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2, x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z")  # engine='auto'
    assert s.engine == "dense"


def test_removed_engines_raise(rng):
    """The row-tile 'pallas' engine is gone; asking for it (or any unknown
    engine) raises instead of falling back."""
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2, x_fill=1.0)
    for engine in ("pallas", "rowtile"):
        with pytest.raises(tq.TfqmrgpuError):
            tq.Solver(a, x, b, precision="c", engine=engine)
