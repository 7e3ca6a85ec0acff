"""Fused per-column vector operations of the tfQMR recurrence.

All functions operate on split-complex block vectors ``(re, im)`` of shape
``[nnzb, LM, LN]`` and per-RHS scalar fields of shape ``[nCols, LN]``.
The RHS axis (LN lanes x nCols block columns) is the vectorization axis --
the analogue of the reference mapping RHS columns onto the fast CUDA
thread axis (tfqmrgpu_linalg.hxx:640, README.md:19-20).

Reductions (dotp/nrm2) are *segmented by block column*: each nonzero block
contributes to the slot of its compressed column index ``colindx`` -- the
reference implements this as a grid-stride partial + log2 tree
(tfqmrgpu_linalg.hxx:480-541); here it is one ``segment_sum`` that XLA
lowers to an efficient sorted-segment reduction.  Per-block partial products
are computed in the data precision and accumulated across blocks in float64,
matching the reference's double accumulators.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .decisions import scalar_dtype

Pair = tuple[jax.Array, jax.Array]


def czero_like(v: Pair) -> Pair:
    return jnp.zeros_like(v[0]), jnp.zeros_like(v[1])


# ------------------------------------------------------------------ scatter

def add_rhs(v: Pair, b: Pair, scal: float, subset: jax.Array) -> Pair:
    """v[subset[i]] += scal * b[i]  (reference: add_RHS_kernel,
    tfqmrgpu_linalg.hxx:383-428).  ``subset`` indices are unique by
    construction (one X slot per B block), so scatter-add never collides."""
    return (
        v[0].at[subset].add(scal * b[0], unique_indices=True),
        v[1].at[subset].add(scal * b[1], unique_indices=True),
    )


def set_unit_blocks(nnzb: int, lm: int, ln: int, dtype,
                    re_part: float = 1.0, im_part: float = 0.0) -> Pair:
    """Blocks holding columns of the unit matrix: v[inzb, j % LM, j] = 1
    (reference: set_unit_blocks_kernel, tfqmrgpu_linalg.hxx:432-455)."""
    i = jax.lax.broadcasted_iota(jnp.int32, (lm, ln), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (lm, ln), 1)
    mask = (j % lm) == i
    blk_re = jnp.where(mask, jnp.asarray(re_part, dtype), jnp.zeros((), dtype))
    blk_im = jnp.where(mask, jnp.asarray(im_part, dtype), jnp.zeros((), dtype))
    return (jnp.broadcast_to(blk_re, (nnzb, lm, ln)),
            jnp.broadcast_to(blk_im, (nnzb, lm, ln)))


# ------------------------------------------------------------- reductions

@partial(jax.jit, static_argnames=("ncols",))
def dotp(x: Pair, y: Pair, colindx: jax.Array, ncols: int) -> Pair:
    """Per-column unconjugated inner product  z[col] = sum_{blk in col} x.y.

    Returns float64 (re, im) of shape [ncols, LN].  Mirrors ``dotp``
    (tfqmrgpu_linalg.hxx:545-588): complex product WITHOUT conjugation,
    contracted over the LM axis, segmented by colindx, double accumulation.
    """
    # per-block partials over LM in the data precision (reference: real_t
    # products into double accumulators; the LM-length partial is benign)
    pr = jnp.sum(x[0] * y[0] - x[1] * y[1], axis=1)  # [nnzb, LN]
    pi = jnp.sum(x[0] * y[1] + x[1] * y[0], axis=1)
    pr = pr.astype(scalar_dtype())
    pi = pi.astype(scalar_dtype())
    zr = jax.ops.segment_sum(pr, colindx, num_segments=ncols)
    zi = jax.ops.segment_sum(pi, colindx, num_segments=ncols)
    return zr, zi


@partial(jax.jit, static_argnames=("ncols",))
def nrm2(x: Pair, colindx: jax.Array, ncols: int) -> jax.Array:
    """Per-column squared norm  d[col] = sum_{blk in col} |x|^2, float64
    [ncols, LN]  (reference: nrm2, tfqmrgpu_linalg.hxx:590-626; note the
    reference's "norm" is the SQUARED 2-norm)."""
    p = jnp.sum(x[0] * x[0] + x[1] * x[1], axis=1).astype(scalar_dtype())
    return jax.ops.segment_sum(p, colindx, num_segments=ncols)


# ----------------------------------------------------------- axpy / xpay

def _gather_scalar(a: Pair, colindx: jax.Array, dtype) -> Pair:
    """a[colindx] broadcast over the LM axis -> [nnzb, 1, LN]."""
    ar = a[0].astype(dtype)[colindx][:, None, :]
    ai = a[1].astype(dtype)[colindx][:, None, :]
    return ar, ai


def axpy(y: Pair, x: Pair, a: Pair, colindx: jax.Array) -> Pair:
    """y := a[col] * x + y with per-(column, RHS) complex scalar a
    (reference: col_axpay<ScaleX=true>, tfqmrgpu_linalg.hxx:629-685)."""
    ar, ai = _gather_scalar(a, colindx, y[0].dtype)
    return (ar * x[0] - ai * x[1] + y[0],
            ai * x[0] + ar * x[1] + y[1])


def xpay(y: Pair, a: Pair, x: Pair, colindx: jax.Array) -> Pair:
    """y := x + a[col] * y  (reference: col_axpay<ScaleX=false>,
    tfqmrgpu_linalg.hxx:629-704)."""
    ar, ai = _gather_scalar(a, colindx, y[0].dtype)
    return (x[0] + ar * y[0] - ai * y[1],
            x[1] + ai * y[0] + ar * y[1])


# ------------------------------------------------------------ flop models
# (reference flop accounting: tfqmrgpu_linalg.hxx:587,625,684,703)

def flops_dotp(nnzb: int, lm: int, ln: int) -> float:
    return nnzb * 4.0 * 2 * lm * ln


def flops_nrm2(nnzb: int, lm: int, ln: int) -> float:
    return nnzb * 4.0 * 1 * lm * ln


def flops_axpy(nnzb: int, lm: int, ln: int) -> float:
    return nnzb * 8.0 * lm * ln
