"""The pair-walk SpMM kernel (ops/pairwalk.py): interpret-mode parity with
the NumPy pair walk on the CPU, its shape routing, and -- marked ``gpu`` --
the compiled kernel on the card."""

import jax.numpy as jnp
import numpy as np
import pytest

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu.ops import pairwalk
from tfqmrgpu_tpu.plan import create_plan
from tfqmrgpu_tpu.workloads import (pair_walk_reference, plan_pair_y,
                                    synthesized_golden_pairs)

from conftest import make_random_problem

# float32: sums of a few LM-deep products in another order than NumPy's;
# float64: round-off, and an f32-accumulating product (~1e-7) fails it
GATES = {np.float32: 1e-5, np.float64: 1e-12}


def _banded(rng):
    pa, px, py, ny, na, nx = synthesized_golden_pairs(8, 2, 3)
    return pa, px, py, ny, na, nx


def _random(rng):
    na, nx, ny, n = 9, 11, 7, 40
    py = np.sort(rng.integers(0, ny, n))
    return rng.integers(0, na, n), rng.integers(0, nx, n), py, ny, na, nx


def _column_sparse(rng):
    # a sparse X grid (x_fill 0.4): pair counts vary per Y block
    a, x, b = make_random_problem(rng, mb=9, lm=1, ln=1, ncols=4,
                                  x_fill=0.4)
    plan = create_plan(a, x, b)
    return (plan.pairs[:, 0].astype(np.int64),
            plan.pairs[:, 1].astype(np.int64), plan_pair_y(plan),
            plan.nnzb_x, plan.nnzb_a, plan.nnzb_x)


def _empty_rows(rng):
    pa, px, py, ny, na, nx = _banded(rng)
    keep = (py % 3) != 1                 # every third Y block gets no pair
    return pa[keep], px[keep], py[keep], ny, na, nx


def _scattered(rng):
    # uniform pair counts, operands drawn from anywhere
    na, nx, ny, k = 13, 17, 6, 4
    return (rng.permutation(ny * k) % na, rng.permutation(ny * k) % nx,
            np.repeat(np.arange(ny), k), ny, na, nx)


PATTERNS = {"banded": _banded, "random": _random,
            "column_sparse": _column_sparse, "empty_rows": _empty_rows,
            "scattered": _scattered}


def _run(pattern, dtype, lm, ln, rng, interpret=True):
    pa, px, py, ny, na, nx = PATTERNS[pattern](rng)
    ac = (rng.standard_normal((na, lm, lm))
          + 1j * rng.standard_normal((na, lm, lm)))
    xc = (rng.standard_normal((nx, lm, ln))
          + 1j * rng.standard_normal((nx, lm, ln)))
    a = (jnp.asarray(ac.real.astype(dtype)), jnp.asarray(ac.imag.astype(dtype)))
    x = (jnp.asarray(xc.real.astype(dtype)), jnp.asarray(xc.imag.astype(dtype)))
    y = pairwalk.spmm_pairwalk(
        pairwalk.kernel_a(*a), x,
        jnp.asarray(pairwalk.starts_from_pair_y(py, ny)),
        jnp.asarray(np.asarray(pa, np.int32)),
        jnp.asarray(np.asarray(px, np.int32)), interpret=interpret)
    got = np.asarray(y[0]) + 1j * np.asarray(y[1])
    want = pair_walk_reference(ac, xc, pa, px, py, ny)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < GATES[dtype], (pattern, dtype, lm, err)
    return got, want


@pytest.mark.parametrize("lm", [16, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_pairwalk_interpret_matches_pair_walk(rng, pattern, dtype, lm):
    _run(pattern, dtype, lm, lm, rng)


def test_pairwalk_empty_rows_are_zero(rng):
    got, _ = _run("empty_rows", np.float64, 16, 16, rng)
    assert np.all(got[1::3] == 0)


def test_pairwalk_column_tiles(rng):
    """LM * LN over 2048 splits the RHS columns over programs."""
    assert pairwalk.column_tile(32, 32) == 32
    assert pairwalk.column_tile(16, 64) == 64
    assert pairwalk.column_tile(64, 64) == 32
    _run("random", np.float64, 64, 64, rng)


@pytest.mark.parametrize("lm,ln,ok", [(16, 16, True), (16, 64, True),
                                      (32, 64, True), (64, 64, True),
                                      (8, 8, False), (4, 32, False),
                                      (8, 64, False), (16, 24, False)])
def test_pairwalk_supports(lm, ln, ok):
    assert pairwalk.supports(lm, ln) is ok


def test_pairwalk_refuses_unsupported_shapes(rng):
    a = (jnp.zeros((2, 8, 8)), jnp.zeros((2, 8, 8)))
    x = (jnp.zeros((2, 8, 8)), jnp.zeros((2, 8, 8)))
    st = jnp.asarray(np.array([0, 1, 2], np.int32))
    idx = jnp.asarray(np.array([0, 1], np.int32))
    with pytest.raises(ValueError, match="LM >= 16"):
        pairwalk.spmm_pairwalk(a, x, st, idx, idx, interpret=True)
    a16 = (jnp.zeros((2, 16, 16), jnp.float32),) * 2
    x16 = (jnp.zeros((2, 16, 16), jnp.float64),) * 2
    with pytest.raises(ValueError, match="one dtype"):
        pairwalk.spmm_pairwalk(a16, x16, st, idx, idx, interpret=True)


def test_pairs_engine_refuses_small_blocks(rng):
    """LM < 16 goes to the XLA engine; asking for 'pairs' there raises."""
    a, x, b = make_random_problem(rng, mb=6, lm=8, ln=8, ncols=2,
                                  x_fill=1.0)
    with pytest.raises(tq.TfqmrgpuError, match="power-of-two LM"):
        tq.Solver(a, x, b, precision="z", engine="pairs", interpret=True)


@pytest.mark.parametrize("lm", [16, 32])
@pytest.mark.parametrize("prec", ["c", "z"])
def test_pairs_engine_solve_matches_xla(rng, prec, lm):
    """The 'pairs' engine (kernel interpreted) follows the XLA engine's
    iteration path: same recurrence, same shadow vector."""
    cdt = np.complex128 if prec == "z" else np.complex64
    tol = 1e-10 if prec == "z" else 1e-5
    a, x, b = make_random_problem(rng, mb=7, lm=lm, ln=lm, ncols=2,
                                  x_fill=0.7, dtype=cdt)
    x1, i1 = tq.solve(a, x, b, precision=prec, engine="xla",
                      tolerance=tol, max_iterations=300)
    s = tq.Solver(a, x, b, precision=prec, engine="pairs", interpret=True)
    i2 = s.solve(tolerance=tol, max_iterations=300)
    assert i2.return_status == 0
    assert abs(i2.iterations_needed - i1.iterations_needed) <= 1
    atol = 1e-3 if prec == "c" else 1e-9
    np.testing.assert_allclose(s.get_matrix("X"), x1.data, atol=atol)


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_pairwalk_compiled_matches_pair_walk(gpu):
    import chip_smoke

    chip_smoke.check_kernel_shapes(interpret=False)


@pytest.mark.gpu
def test_auto_routes_to_pairs_on_gpu(gpu):
    import chip_smoke

    assert chip_smoke.check_auto_routing() == {8: "xla", 32: "pairs"}
