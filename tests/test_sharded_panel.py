"""Mesh-sharded dense-panel solver: parity with the single-device engine."""

import numpy as np

from tfqmrgpu_tpu import Solver, create_plan
from tfqmrgpu_tpu.errors import Status
from tfqmrgpu_tpu.parallel import make_mesh
from tfqmrgpu_tpu.parallel.sharded_panel import ShardedPanelSolver

from conftest import dense_from_bsr, make_random_problem


def _run(rng, pr, pc, mb=12, lm=4, ln=4, ncols=4, prec="c"):
    dt = np.complex64 if prec == "c" else np.complex128
    a, x, b = make_random_problem(rng, mb=mb, lm=lm, ln=ln, ncols=ncols,
                                  x_fill=1.0, dtype=dt)
    tol = 1e-5 if prec == "c" else 1e-9
    s0 = Solver(a, x, b, precision=prec, engine="dense")
    i0 = s0.solve(tolerance=tol, max_iterations=400)

    plan = create_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    sp = ShardedPanelSolver(plan, make_mesh(pr, pc), precision=prec)
    got, info = sp.solve(a.data.real, a.data.imag,
                         b.data.real, b.data.imag,
                         tolerance=tol, max_iterations=400)
    assert info["return_status"] == int(Status.SUCCESS)
    assert abs(info["iterations"] - i0.iterations_needed) <= 1
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(got), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    gate = 1e-3 if prec == "c" else 1e-7
    assert np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd)) < gate
    return info


def test_sharded_panel_rows_only(rng):
    _run(rng, 4, 1)


def test_sharded_panel_2d(rng):
    _run(rng, 2, 2)


def test_sharded_panel_uneven_padding(rng):
    # mb=13 rows over 4 shards, 3 cols over 2 shards: padding paths
    _run(rng, 4, 2, mb=13, ncols=3)


def test_sharded_panel_z(rng):
    _run(rng, 2, 1, prec="z")


def test_solve_sharded_one_call(rng):
    """The high-level mesh convenience picks an engine and solves."""
    from tfqmrgpu_tpu.parallel import solve_sharded

    lm = ln = 8
    a, x, b = make_random_problem(rng, mb=8, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    got, info = solve_sharded(a, x, b, n_devices=4, tolerance=1e-4,
                              max_iterations=300)
    # a small operator: the dense-panel engine, on all four devices
    assert info["return_status"] == 0 and info["engine"] == "panel"
    assert info["shard_devices"] == [0, 1, 2, 3]
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(got), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    assert np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd)) < 5e-3
