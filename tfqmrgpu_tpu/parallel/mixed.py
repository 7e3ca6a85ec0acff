"""Mixed-precision ('m') sharded solve: f32 mesh-sharded iterations plus
f64-residual iterative refinement.

The reference declares precision 'm' but never enabled it
(tfqmrgpu.cu:42 "mixed precision is still buggy"); the single-device
pipeline lives in ``solver.solve_mixed``/``refine_mixed``.  This module is
its multi-device analogue: the correction solves run on a sharded f32
engine (panel or block-list over the mesh), while one f64 SpMM per round
measures the true residual.  The refinement loop is host-driven and
cheap (a handful of rounds); the sharded engine does all the iteration
work.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def solve_sharded_mixed(a, x, b, plan, sp, *, tolerance: float = 1e-9,
                        max_iterations: int = 999,
                        c_tolerance: float = 1e-4, max_rounds: int = 12,
                        echo: int = 0):
    """Refine a sharded f32 solve to f64 residuals.

    Args:
      a, x, b: the BSR operands (complex128 data on ``a``/``b``).
      plan: the analyzed Plan (lm/ln set).
      sp: a sharded solver (ShardedPanelSolver / ShardedBlockListSolver)
          built over ``plan`` and a mesh; its ``solve`` must accept
          ``rhs_xshaped``.

    Returns (x_blocks complex128 [nnzbX, LM, LN], info dict).
    """
    if not jax.config.read("jax_enable_x64"):
        from .. import enable_x64

        enable_x64()
    from ..ops import layout as lops
    from ..ops.blocksparse import BlockSparseAction
    from ..refine import refinement_loop

    lm, ln = int(plan.lm), int(plan.ln)
    ar = np.asarray(a.data.real)
    ai = np.asarray(a.data.imag)

    # stage 1: f32 sharded solve of A X == B
    maxit_c = min(max_iterations, max(150, max_iterations // 4))
    xc, info_c = sp.solve(ar, ai, np.asarray(b.data.real),
                          np.asarray(b.data.imag),
                          tolerance=max(c_tolerance, tolerance),
                          max_iterations=maxit_c)

    # f64 residual operator (XLA pair-list engine, native f64 products --
    # one multiply per round, off the iteration hot path)
    a_re64, a_im64 = lops.complex_to_planes(a.data, np.float64)
    act = BlockSparseAction.from_plan(plan, a_re64, a_im64, engine="xla",
                                      ln=ln)
    apply64 = jax.jit(lambda xr, xi: act.multiply((xr, xi)))

    colindx = plan.colindx.astype(np.int64)
    bx64 = np.zeros((plan.nnzb_x, lm, ln), np.complex128)
    np.add.at(bx64, plan.subset.astype(np.int64),
              np.asarray(b.data, np.complex128))
    bn2 = np.zeros((plan.ncols, ln))
    np.add.at(bn2, colindx, (np.abs(bx64) ** 2).sum(axis=1))

    def _correction(r, res2, stall, inner_max):
        rr, ri = (np.asarray(r[0], np.float32), np.asarray(r[1], np.float32))
        dx, info_d = sp.solve(ar, ai, rr, ri,
                              tolerance=stall, max_iterations=inner_max,
                              rhs_xshaped=True)
        dx = np.asarray(dx)
        return ((np.ascontiguousarray(dx.real),
                 np.ascontiguousarray(dx.imag)),
                int(info_d["iterations"]))

    res = refinement_loop(
        apply64=apply64, bx64=bx64, colindx=colindx, bn2=bn2,
        x0=np.asarray(xc), tolerance=tolerance,
        max_iterations=max_iterations,
        total_iters=int(info_c["iterations"]),
        inner_base=int(info_c["iterations"]),
        solve_correction=_correction,
        stall_seed=float(info_c["residuum"]),
        echo=echo, max_rounds=max_rounds, label="sharded refine")

    info = dict(info_c)
    info.update(iterations=res["total_iters"], residuum=res["ratio"],
                refine_rounds=res["rounds"], converged=res["converged"],
                c_iterations=int(info_c["iterations"]))
    return res["x"], info
