"""Pair-walk block-SpMM kernel (Pallas through Triton), after gemmNxNf.

The reference's hot kernel ``gemmNxNf<real_t,LM,LN,...>``
(tfqmrgpu_blockmult.hxx:10-93) runs one thread block per output block
``Y[iY]`` and walks that block's slice of the multiplication pair list,

    Y[iY] = sum_{p in [starts[iY], starts[iY+1])}  A[pair_a[p]] @ X[pair_x[p]],

keeping the complex accumulators in registers, so no per-pair product ever
reaches device memory.  This kernel has the same shape: one program per
(Y block, RHS column tile); the program reads its own ``starts`` range,
loops over its pairs with ``lax.fori_loop``, loads the A block and the X
block of each pair by index (re and im planes), accumulates the four real
products and writes ``Y[iY]`` once.  RHS columns sit on the fast axis.

Two product forms, chosen by dtype:

* float32: ``lax.dot_general`` on the [LM, LM] x [LM, TN] blocks at
  ``Precision.HIGHEST`` (Triton's IEEE f32 dot, no TF32 rounding).  Triton's
  dot needs every dimension >= 16.
* float64: the Triton lowering accumulates every dot in float32, so an f64
  dot would come back at f32 accuracy.  The f64 form keeps A transposed
  (as gemmNxNf does) and contracts ``KC`` rows of A^T against ``KC`` rows
  of X per step as a broadcast product summed over the chunk axis, in
  float64 throughout.

The launch parameters are the fastest of those measured on an H100 SXM
(700 W) at the golden plan's size, LM = LN = 32 (PERF.md).  Block shapes
the kernel does not take (``supports``) go to the XLA block-list engine.
``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests);
nothing decides it from the backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

Pair = tuple[jax.Array, jax.Array]

# Triton's dot needs M, N and K of at least 16
MIN_LM = 16
# rows of A^T (and of X) per float64 step
F64_KC = 2


def supports(lm: int, ln: int) -> bool:
    """Whether the kernel takes this block shape: power-of-two LM >= 16
    (Triton's dot) and power-of-two LN (Triton's block shapes)."""
    return lm >= MIN_LM and not lm & (lm - 1) and not ln & (ln - 1)


def column_tile(lm: int, ln: int) -> int:
    """RHS columns per program: the whole block while an [LM, TN]
    accumulator holds at most 2048 elements, else halved."""
    tn = ln
    while lm * tn > 2048 and tn > 16:
        tn //= 2
    return tn


def kernel_a(a_re, a_im) -> Pair:
    """A planes in the kernel's layout: as given for float32, transposed
    per block for float64 (rows of A^T are columns of A)."""
    if jnp.result_type(a_re) == jnp.float64:
        return jnp.swapaxes(a_re, 1, 2), jnp.swapaxes(a_im, 1, 2)
    return a_re, a_im


def _kernel(starts_ref, pa_ref, px_ref, ar_ref, ai_ref, xr_ref, xi_ref,
            yr_ref, yi_ref, *, lm: int, tn: int):
    iy = pl.program_id(0)
    cols = pl.ds(pl.multiple_of(pl.program_id(1) * tn, tn), tn)
    dt = yr_ref.dtype

    if dt == jnp.float32:
        def mm(u, v):
            return jax.lax.dot_general(
                u, v, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)

        def body(p, acc):
            yr, yi = acc
            ia = pa_ref[p]
            ix = px_ref[p]
            ar, ai = ar_ref[ia], ai_ref[ia]
            xr, xi = xr_ref[ix, :, cols], xi_ref[ix, :, cols]
            return (yr + mm(ar, xr) - mm(ai, xi),
                    yi + mm(ar, xi) + mm(ai, xr))
    else:
        def body(p, acc):
            yr, yi = acc
            ia = pa_ref[p]
            ix = px_ref[p]
            for k0 in range(0, lm, F64_KC):
                ks = pl.ds(k0, F64_KC)
                ar = ar_ref[ia, ks, :][:, :, None]       # [KC, LM, 1]
                ai = ai_ref[ia, ks, :][:, :, None]
                xr = xr_ref[ix, ks, cols][:, None, :]    # [KC, 1, TN]
                xi = xi_ref[ix, ks, cols][:, None, :]
                yr = yr + jnp.sum(ar * xr - ai * xi, axis=0)
                yi = yi + jnp.sum(ar * xi + ai * xr, axis=0)
            return yr, yi

    zero = jnp.zeros((lm, tn), dt)
    yr, yi = jax.lax.fori_loop(starts_ref[iy], starts_ref[iy + 1], body,
                               (zero, zero))
    yr_ref[iy, :, cols] = yr
    yi_ref[iy, :, cols] = yi


@functools.partial(jax.jit, static_argnames=("interpret",))
def spmm_pairwalk(a: Pair, x: Pair, starts: jax.Array, pair_a: jax.Array,
                  pair_x: jax.Array, *, interpret: bool = False) -> Pair:
    """Y = A @ X over the pair list, one program per (Y block, column tile).

    a: (re, im) [nnzbA, LM, LM] in the layout of ``kernel_a``;
    x: (re, im) [nnzbX, LM, LN]; starts: int32[nnzbY + 1] pair offsets per
    Y block; pair_a / pair_x: int32[nPairs], grouped by Y block.
    Returns (re, im) [nnzbY, LM, LN]."""
    lm = int(a[0].shape[1])
    ln = int(x[0].shape[2])
    dt = x[0].dtype
    if not supports(lm, ln):
        raise ValueError(
            f"the pair-walk kernel needs power-of-two LM >= {MIN_LM} and "
            f"power-of-two LN (got LM={lm}, LN={ln})")
    if a[0].dtype != dt or dt not in (jnp.float32, jnp.float64):
        raise ValueError("the pair-walk kernel takes float32 or float64 "
                         f"planes of one dtype (A {a[0].dtype}, X {dt})")
    tn = column_tile(lm, ln)
    nnzb_y = int(starts.shape[0]) - 1
    out = jax.ShapeDtypeStruct((nnzb_y, lm, ln), dt)
    return pl.pallas_call(
        functools.partial(_kernel, lm=lm, tn=tn),
        out_shape=(out, out),
        grid=(nnzb_y, ln // tn),
        interpret=interpret,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        name="tfq_pairwalk",
    )(starts, pair_a, pair_x, a[0], a[1], x[0], x[1])


def starts_from_pair_y(pair_y: np.ndarray, nnzb_y: int) -> np.ndarray:
    """int32[nnzbY + 1] pair offsets from a sorted per-pair Y index."""
    counts = np.bincount(np.asarray(pair_y, np.int64), minlength=nnzb_y)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
