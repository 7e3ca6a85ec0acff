"""Shared bodies of the per-block-size parity tests (one file per engine,
so ``--dist loadfile`` spreads them over workers)."""

import numpy as np

import tfqmrgpu_tpu as tq

from conftest import dense_from_bsr, make_random_problem

SIZES = list(tq.ALLOWED_BLOCK_SIZES)

# solve tolerance and the gate on |X - A^-1 B| / |A^-1 B|: the solve stops
# at the tolerance on the residual, and the diagonally dominant test
# operators keep the error within a small multiple of it
SOLVE = {"z": (1e-10, 1e-8, np.complex128), "c": (1e-5, 1e-3, np.complex64)}
# the multiply against the complex128 pair walk: float32 round-off over
# LM-deep sums; float64 round-off (an f32-accurate product fails it)
SPMM_GATE = {"z": 1e-12, "c": 1e-5}


def solve_parity(rng, lm, ln, prec, engine, **solver_kw):
    """Solve a tiny full-pattern problem and compare with a dense NumPy
    solve of the same system."""
    tol, gate, cdt = SOLVE[prec]
    a, x, b = make_random_problem(rng, mb=5, lm=lm, ln=ln, ncols=2,
                                  x_fill=1.0, dtype=cdt)
    s = tq.Solver(a, x, b, precision=prec, engine=engine, **solver_kw)
    info = s.solve(tolerance=tol, max_iterations=400)
    assert info.return_status == 0, info
    got = dense_from_bsr(x.with_data(s.get_matrix("X")), lm, ln)
    want = np.linalg.solve(dense_from_bsr(a, lm, lm),
                           dense_from_bsr(b, lm, ln))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < gate, (lm, ln, prec, engine, err)


def spmm_parity(rng, lm, ln, prec):
    """The XLA block-list multiply against the NumPy pair walk."""
    from tfqmrgpu_tpu.ops.blocksparse import BlockSparseAction
    from tfqmrgpu_tpu.plan import create_plan
    from tfqmrgpu_tpu.workloads import pair_walk_reference, plan_pair_y

    cdt = SOLVE[prec][2]
    a, x, b = make_random_problem(rng, mb=6, lm=lm, ln=ln, ncols=3,
                                  x_fill=0.6, dtype=cdt)
    plan = create_plan(a, x, b)
    rdt = np.float64 if prec == "z" else np.float32
    act = BlockSparseAction.from_plan(plan, a.data.real.astype(rdt),
                                      a.data.imag.astype(rdt), ln=ln)
    xv = (rng.standard_normal((plan.nnzb_x, lm, ln))
          + 1j * rng.standard_normal((plan.nnzb_x, lm, ln))).astype(cdt)
    y = act.multiply((xv.real.astype(rdt), xv.imag.astype(rdt)))
    got = np.asarray(y[0]) + 1j * np.asarray(y[1])
    want = pair_walk_reference(a.data, xv, plan.pairs[:, 0],
                               plan.pairs[:, 1], plan_pair_y(plan),
                               plan.nnzb_x)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < SPMM_GATE[prec], (lm, ln, prec, err)
