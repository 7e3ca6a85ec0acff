"""Shared mixed-precision iterative-refinement loop.

The 'm' mode iterates in f32 and reaches f64 residuals by classic
iterative refinement -- per round ONE f64 SpMM measures the true residual
r = B - A@x and an f32 engine solves the correction A dX == r.  This loop is the single implementation behind
``solver.refine_mixed`` (single device) and
``parallel.mixed.solve_sharded_mixed`` (mesh); they differ only in how
the correction is solved, injected via ``solve_correction``.  Implements
the mode the reference declares but disables (tfqmrgpu.cu:42 "mixed
precision is still buggy").

The round bookkeeping is device-resident: the f64 residual, its
per-column norms and the iterate update all stay on device; the only
host synchronization per round is the scalar convergence ratio.  All
device state is split re/im float64 planes, the layout every engine
uses.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp


def refinement_loop(*, apply64, bx64: np.ndarray, colindx: np.ndarray,
                    bn2: np.ndarray, x0: np.ndarray, tolerance: float,
                    max_iterations: int, total_iters: int, inner_base: int,
                    solve_correction: Callable, stall_seed: float,
                    flops_per_round: float = 0.0,
                    flops_per_iteration: float = 0.0,
                    echo: int = 0, max_rounds: int = 12,
                    label: str = "refine") -> dict:
    """Run the refinement rounds.

    Args:
      apply64: jitted f64 operator, (x_re, x_im) -> (y_re, y_im) on
        X-shaped [nnzbX, LM, LN] planes.
      bx64: B scattered into X shape, complex128 [nnzbX, LM, LN] (host).
      colindx: int64[nnzbX] compressed column of each X block.
      bn2: [nCols, LN] squared column norms of B (0 where B is empty).
      x0: complex128 starting iterate (the c-stage solution, host).
      total_iters: iterations already spent (c stage).
      inner_base: per-round correction-iteration scale (the c stage's
        count); each correction solve gets min(inner_base, 150) + 50,
        capped by the remaining global budget.
      solve_correction: ((r_re, r_im) f64 DEVICE planes [nnzbX,LM,LN],
        res2 [nCols,LN] numpy, stall, inner_max) -> ((dx_re, dx_im)
        f64 planes, iterations int).
      stall_seed: the c stage's reached residual; the per-round target is
        2x it, clipped to the observed pure-f32 stall band [1e-5, 1e-2].
      flops_per_round / flops_per_iteration: accounting weights (0 = skip).

    Returns dict(x, ratio, total_iters, flops, rounds, converged).
    """
    inv = np.where(bn2 > 0, 1.0 / np.where(bn2 > 0, bn2, 1.0), 0.0)
    # per-round achievable reduction ~ the f32 engine's stall level; seed
    # from what the c stage actually reached, kept away from the extremes
    stall = float(np.clip(2.0 * max(stall_seed, 0.0), 1e-5, 1e-2))
    ncols = bn2.shape[0]
    cidx = jnp.asarray(colindx)
    inv_j = jnp.asarray(inv)
    bx_h = np.asarray(bx64, np.complex128)
    bxr_j = jnp.asarray(np.ascontiguousarray(bx_h.real))
    bxi_j = jnp.asarray(np.ascontiguousarray(bx_h.imag))

    @jax.jit
    def _residual_post(yr, yi):
        """Residual bookkeeping on device: re/im planes, per-column
        squared norms, and the max ratio (the caller's apply64 runs
        outside so numpy-backed test doubles keep working)."""
        rr = bxr_j - jnp.asarray(yr)
        ri = bxi_j - jnp.asarray(yi)
        blk = jnp.sum(rr * rr + ri * ri, axis=1)      # [nnzbX, LN]
        res2 = jax.ops.segment_sum(blk, cidx, num_segments=ncols)
        ratio = jnp.sqrt(jnp.max(res2 * inv_j))
        return rr, ri, res2, ratio

    def residual_round(xr, xi):
        yr, yi = apply64(xr, xi)
        return _residual_post(yr, yi)

    x_re = jnp.asarray(np.ascontiguousarray(np.asarray(x0).real))
    x_im = jnp.asarray(np.ascontiguousarray(np.asarray(x0).imag))
    prev_ratio = np.inf
    ratio = np.inf
    converged = False
    rounds = 0
    flops = 0.0
    for rnd in range(max_rounds):
        rr, ri, res2_d, ratio_d = residual_round(x_re, x_im)
        flops += flops_per_round
        ratio = float(ratio_d)                  # the ONLY host sync
        if echo > 1:
            print(f"# {label} round {rnd}: rel residual {ratio:.3e}")
        if ratio <= tolerance:
            converged = True
            break
        if ratio > 0.25 * prev_ratio or total_iters >= max_iterations:
            break                 # stalled; caller may fall back to 'z'
        prev_ratio = ratio
        rounds += 1
        inner_max = min(max_iterations - total_iters,
                        min(inner_base, 150) + 50)
        (dxr, dxi), inner_iters = solve_correction(
            (rr, ri), np.asarray(res2_d), stall, inner_max)
        x_re = x_re + jnp.asarray(dxr, jnp.float64)
        x_im = x_im + jnp.asarray(dxi, jnp.float64)
        total_iters += int(inner_iters)
        flops += int(inner_iters) * flops_per_iteration
    x_cur = np.asarray(x_re) + 1j * np.asarray(x_im)
    return dict(x=x_cur, ratio=ratio, total_iters=total_iters, flops=flops,
                rounds=rounds, converged=converged)
