"""Unit tests for the shared mixed-precision refinement loop
(tfqmrgpu_tpu/refine.py) and regression locks for its callers'
accounting/model fixes."""

import numpy as np
import pytest

from tfqmrgpu_tpu.refine import refinement_loop


def _identity_setup(ncols=2, lm=2, ln=3, nnzb=4):
    """A == I on a trivial pattern: residual of iterate x is b - x."""
    colindx = np.arange(nnzb, dtype=np.int64) % ncols
    rng = np.random.default_rng(0)
    bx = (rng.standard_normal((nnzb, lm, ln))
          + 1j * rng.standard_normal((nnzb, lm, ln)))
    bn2 = np.zeros((ncols, ln))
    np.add.at(bn2, colindx, (np.abs(bx) ** 2).sum(axis=1))

    def apply64(xr, xi):
        return np.asarray(xr), np.asarray(xi)

    return apply64, bx, colindx, bn2


def test_refinement_loop_converges_with_exact_corrections():
    apply64, bx, colindx, bn2 = _identity_setup()
    calls = []

    def correction(r, res2, stall, inner_max):
        calls.append(inner_max)
        rr, ri = np.asarray(r[0]), np.asarray(r[1])
        return (0.9 * rr, 0.9 * ri), 7   # residual shrinks 10x per round

    res = refinement_loop(
        apply64=apply64, bx64=bx, colindx=colindx, bn2=bn2,
        x0=np.zeros_like(bx), tolerance=1e-3, max_iterations=1000,
        total_iters=30, inner_base=30, solve_correction=correction,
        stall_seed=1e-4, flops_per_round=10.0, flops_per_iteration=2.0)
    assert res["converged"]
    assert res["rounds"] == len(calls)
    # 0.1^k <= 1e-3 -> 3 rounds of 10x gain from rel residual 1.0 (float
    # rounding can leave the 3rd check epsilon above tolerance)
    assert res["rounds"] in (3, 4)
    assert res["total_iters"] == 30 + 7 * len(calls)
    # one extra residual probe (the converged check) beyond the rounds
    assert res["flops"] == pytest.approx(10.0 * (len(calls) + 1)
                                         + 2.0 * 7 * len(calls))
    # inner budget: min(inner_base, 150) + 50 while global budget is slack
    assert calls[0] == 80
    # the refined iterate solves A x == b
    assert np.max(np.abs(res["x"] - bx)) / np.max(np.abs(bx)) < 2e-3


def test_refinement_loop_breaks_on_stall():
    apply64, bx, colindx, bn2 = _identity_setup()

    def correction(r, res2, stall, inner_max):
        rr, ri = np.asarray(r[0]), np.asarray(r[1])
        return (0.5 * rr, 0.5 * ri), 5   # only halves -> ratio > 0.25*prev

    res = refinement_loop(
        apply64=apply64, bx64=bx, colindx=colindx, bn2=bn2,
        x0=np.zeros_like(bx), tolerance=1e-12, max_iterations=1000,
        total_iters=0, inner_base=100, solve_correction=correction,
        stall_seed=1e-4)
    assert not res["converged"]
    assert res["rounds"] == 1      # second residual check trips the stall
    assert res["ratio"] > 0


def test_refinement_loop_respects_global_budget():
    apply64, bx, colindx, bn2 = _identity_setup()

    def correction(r, res2, stall, inner_max):
        assert inner_max <= 12     # capped by the remaining global budget
        rr, ri = np.asarray(r[0]), np.asarray(r[1])
        return (0.5 * rr, 0.5 * ri), inner_max

    res = refinement_loop(
        apply64=apply64, bx64=bx, colindx=colindx, bn2=bn2,
        x0=np.zeros_like(bx), tolerance=1e-30, max_iterations=12,
        total_iters=0, inner_base=500, solve_correction=correction,
        stall_seed=1e-4)
    assert not res["converged"]
    assert res["total_iters"] >= 12   # then the budget check breaks the loop
