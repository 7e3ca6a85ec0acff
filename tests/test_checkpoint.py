"""Checkpoint/resume (restart-based), initial guess, plan serialization."""

import numpy as np
import pytest

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu import Solver
from tfqmrgpu_tpu.errors import Status
from tfqmrgpu_tpu.plan import Plan

from conftest import dense_from_bsr, make_random_problem


@pytest.mark.parametrize("engine,prec", [("dense", "z"), ("pairs", "c"),
                                         ("xla", "z")])
def test_initial_guess_reduces_iterations(rng, engine, prec):
    # the pair-walk kernel takes LM >= 16; it runs interpreted on the CPU
    lm = ln = 16 if engine == "pairs" else 4
    kw = dict(interpret=True) if engine == "pairs" else {}
    dt = np.complex64 if prec == "c" else np.complex128
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0, dtype=dt)
    tol = 1e-5 if prec == "c" else 1e-9
    s = Solver(a, x, b, precision=prec, engine=engine, **kw)
    info0 = s.solve(tolerance=tol, max_iterations=400)
    assert info0.return_status == int(Status.SUCCESS)
    x_sol = s.get_matrix("X")

    # restarting FROM the solution must converge (near-)immediately
    s2 = Solver(a, x, b, precision=prec, engine=engine, **kw)
    s2.set_matrix("X", x_sol)
    info1 = s2.solve(tolerance=tol, max_iterations=400)
    assert info1.return_status == int(Status.SUCCESS)
    assert info1.iterations_needed <= max(3, info0.iterations_needed // 3)
    # and the returned X (X0 + dX) still solves the system
    got = s2.get_matrix("X")
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(got), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    gate = 1e-3 if prec == "c" else 1e-7
    assert np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd)) < gate


def test_checkpointed_solve_resumes(tmp_path, rng):
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0)
    state = str(tmp_path / "state.npz")
    s = Solver(a, x, b, precision="z", engine="dense")
    ref_iters = s.solve(tolerance=1e-10, max_iterations=500).iterations_needed

    # run in tiny chunks with persistence; simulate a crash after chunk 1
    s1 = Solver(a, x, b, precision="z", engine="dense")
    info = s1.solve_checkpointed(tolerance=1e-10,
                                 max_iterations=max(2, ref_iters // 4),
                                 chunk=max(2, ref_iters // 4),
                                 state_path=state)
    assert info.return_status != int(Status.SUCCESS)   # interrupted
    import os
    assert os.path.exists(state)

    # "new process": resume from the state file and finish
    s2 = Solver(a, x, b, precision="z", engine="dense")
    info2 = s2.solve_checkpointed(tolerance=1e-10, max_iterations=500,
                                  chunk=max(2, ref_iters // 2),
                                  state_path=state)
    assert info2.return_status == int(Status.SUCCESS)
    assert not os.path.exists(state)                   # cleaned up
    got = s2.get_matrix("X")
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(got), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    assert np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd)) < 1e-8


def test_plan_save_load(tmp_path, rng):
    a, x, b = make_random_problem(rng, mb=9, lm=4, ln=8, ncols=2)
    plan = tq.create_plan(a, x, b)
    plan.lm, plan.ln = 4, 8
    path = str(tmp_path / "plan.npz")
    plan.save(path)
    p2 = Plan.load(path)
    np.testing.assert_array_equal(p2.pairs, plan.pairs)
    np.testing.assert_array_equal(p2.starts, plan.starts)
    np.testing.assert_array_equal(p2.colindx, plan.colindx)
    assert (p2.nrows, p2.ncols, p2.lm, p2.ln) == (
        plan.nrows, plan.ncols, 4, 8)
    # a loaded plan drives a Solver without re-analysis
    s = Solver(a, x, b, precision="z", plan=p2)
    info = s.solve(tolerance=1e-8, max_iterations=300)
    assert info.return_status == int(Status.SUCCESS)
