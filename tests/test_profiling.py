"""Observability: plan cache, trace ranges, roofline audit."""

import numpy as np

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu import profiling
from tfqmrgpu_tpu.plan import _PLAN_CACHE, create_plan

from conftest import make_random_problem


def test_plan_cache_hits_and_isolates_stats(rng):
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2)
    _PLAN_CACHE.clear()
    p1 = create_plan(a, x, b)
    assert len(_PLAN_CACHE) == 1
    p1.flops_performed_all = 123.0
    p2 = create_plan(a, x, b)
    assert p2.flops_performed_all == 0.0      # fresh stats on each hit
    np.testing.assert_array_equal(p1.pairs, p2.pairs)
    assert p1.pairs is p2.pairs               # tables shared, not copied


def test_trace_noop_and_enabled(monkeypatch):
    with profiling.trace("x"):
        pass
    monkeypatch.setenv("TFQ_TRACE", "1")
    with profiling.trace("y"):
        pass


def test_roofline_report(rng):
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=8, ncols=2,
                                  x_fill=1.0)
    s = tq.Solver(a, x, b, precision="z", engine="dense")
    # a CPU run carries no device peaks: price it against the H100 table
    info, best, roof = profiling.timed_solve(
        s, tolerance=1e-8, max_iterations=300, repeats=2,
        device_kind="NVIDIA H100 80GB HBM3")
    assert info.return_status == 0
    assert roof.flops_per_iteration > 0 and roof.bytes_per_iteration > 0
    assert roof.fraction_of_light is not None
    assert "roofline[" in str(roof)


def test_autotune_solver_picks_working_engine(rng, tmp_path, monkeypatch):
    from tfqmrgpu_tpu.autotune import autotune_solver

    monkeypatch.setenv("TFQ_AUTOTUNE_CACHE", str(tmp_path))
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    s, table = autotune_solver(a, x, b, precision="c", nrep=4)
    assert any("ms_per_multiply" in row for row in table)
    info = s.solve(tolerance=1e-4, max_iterations=200)
    assert info.return_status == 0
