"""Mixed-precision ('m') sharded solve: f32 mesh iterations + f64-residual
refinement (parallel/mixed.py).  The multi-device analogue of the
reference's declared-but-disabled 'm' mode (tfqmrgpu.cu:42)."""

import jax
import numpy as np
import pytest

from tfqmrgpu_tpu.parallel import solve_sharded

from conftest import dense_from_bsr, make_random_problem

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 simulated devices")


@pytest.mark.parametrize("engine", ["panel", "blocklist"])
def test_sharded_mixed_reaches_f64_residuals(rng, engine):
    """precision 'm' must push the relative residual far below the f32
    floor (~1e-5) that plain 'c' stalls at."""
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=12, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex128)
    tol = 1e-9
    got, info = solve_sharded(a, x, b, n_devices=4, engine=engine,
                              precision="m", tolerance=tol,
                              max_iterations=600)
    assert info["engine"] == engine
    assert info["converged"], info
    assert info["refine_rounds"] >= 1
    assert got.dtype == np.complex128
    ad = dense_from_bsr(a, lm, lm)
    xd = dense_from_bsr(x.with_data(got), lm, ln)
    bd = dense_from_bsr(b, lm, ln)
    rel = np.linalg.norm(ad @ xd - bd) / np.linalg.norm(bd)
    assert rel < 1e-8, (engine, rel)


def test_sharded_mixed_beats_plain_c(rng):
    """On the same problem, 'm' must land orders of magnitude below 'c'."""
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex128)
    ad = dense_from_bsr(a, lm, lm)
    bd = dense_from_bsr(b, lm, ln)

    def rel_of(blocks):
        xd = dense_from_bsr(x.with_data(np.asarray(blocks)
                                        .astype(np.complex128)), lm, ln)
        return np.linalg.norm(ad @ xd - bd) / np.linalg.norm(bd)

    xc, _ = solve_sharded(a, x, b, n_devices=4, engine="panel",
                          precision="c", tolerance=1e-12,
                          max_iterations=400)
    xm, im = solve_sharded(a, x, b, n_devices=4, engine="panel",
                           precision="m", tolerance=1e-10,
                           max_iterations=800)
    assert rel_of(xm) < 1e-3 * max(rel_of(xc), 1e-30) or rel_of(xm) < 1e-10


def test_sharded_bad_precision_raises(rng):
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=6, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    with pytest.raises(ValueError):
        solve_sharded(a, x, b, n_devices=4, precision="z")
