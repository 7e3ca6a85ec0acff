"""Panel representation: the dense engine's layout of X-shaped vectors.

The reference stores X-shaped vectors as lists of nonzero blocks and gathers
per block through index tables (colindx, subset, pair lists).  The dense
engine instead works on **dense row panels**

    v[mb*LM, ncc, LN]   (re, im planes)

where ``ncc`` is the number of compressed (non-empty) block columns of X and
positions outside X's sparsity pattern are zero.  Consequences:

* block-SpMM  Y = A @ X  becomes one masked matmul of the densified A
  against the panel (contraction depth mb*LM), and the pattern truncation
  of the reference's pair list (Y restricted to X's pattern,
  tfqmrgpu.cu:183-230) is a cheap elementwise mask;
* the per-column segmented reductions dotp/nrm2 (tfqmrgpu_linalg.hxx:480-541)
  collapse to plain column sums -- colindx disappears;
* axpy/xpay per-(column, RHS) scaling is a broadcast multiply -- no gather;
* add_RHS scatter (tfqmrgpu_linalg.hxx:383-428) becomes ``v + scal * b_panel``
  with B pre-scattered into a panel once.

Zeros inside the panel waste compute only in the SpMM (density factor), so
the solver picks this engine for small or dense operators only.

This module holds the layout descriptor, pack/unpack converters, and the
panel-form tfQMR primitives of the dense engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .decisions import scalar_dtype

Pair = tuple[jax.Array, jax.Array]


@dataclasses.dataclass(frozen=True)
class PanelLayout:
    """Host-side descriptor mapping a plan's X/B patterns to panel slots."""

    mb: int          # block rows
    lm: int
    ncc: int         # compressed non-empty block columns of X
    ln: int
    # per X block: (block row, compressed block column)
    x_rows: np.ndarray       # int32[nnzbX]
    x_cols: np.ndarray       # int32[nnzbX]  (== plan.colindx)
    # per B block: position via the X block it scatters into
    b_rows: np.ndarray       # int32[nnzbB]
    b_cols: np.ndarray       # int32[nnzbB]
    mask: np.ndarray         # bool[mb, ncc]  X-pattern occupancy

    @classmethod
    def from_plan(cls, plan) -> "PanelLayout":
        x_rows = np.repeat(np.arange(plan.nrows, dtype=np.int32),
                           np.diff(plan.rowptr_x))
        x_cols = plan.colindx.astype(np.int32)
        sub = plan.subset.astype(np.int64)
        mask = np.zeros((plan.nrows, plan.ncols), dtype=bool)
        mask[x_rows, x_cols] = True
        return cls(mb=plan.nrows, lm=plan.lm, ncc=plan.ncols, ln=plan.ln,
                   x_rows=x_rows, x_cols=x_cols,
                   b_rows=x_rows[sub], b_cols=x_cols[sub], mask=mask)

    @property
    def nr(self) -> int:
        return self.mb * self.lm

    def pack_x(self, blocks: np.ndarray) -> np.ndarray:
        """[nnzbX, LM, LN] block list -> [mb*LM, ncc, LN] panel."""
        p = np.zeros((self.mb, self.lm, self.ncc, self.ln), blocks.dtype)
        p[self.x_rows, :, self.x_cols, :] = blocks
        return p.reshape(self.nr, self.ncc, self.ln)

    def pack_b(self, blocks: np.ndarray) -> np.ndarray:
        """[nnzbB, LM, LN] block list -> panel (zeros elsewhere)."""
        p = np.zeros((self.mb, self.lm, self.ncc, self.ln), blocks.dtype)
        p[self.b_rows, :, self.b_cols, :] = blocks
        return p.reshape(self.nr, self.ncc, self.ln)

    def unpack_x(self, panel: np.ndarray) -> np.ndarray:
        """[mb*LM, ncc, LN] panel -> [nnzbX, LM, LN] block list."""
        p = np.asarray(panel).reshape(self.mb, self.lm, self.ncc, self.ln)
        return p[self.x_rows, :, self.x_cols, :]

    def unit_b_blocks(self, dtype) -> np.ndarray:
        """Unit-matrix columns at B positions (set_unit_blocks semantics,
        tfqmrgpu_linalg.hxx:432-472): block[i, j % LM, j] = 1."""
        i = np.arange(self.lm)[:, None]
        j = np.arange(self.ln)[None, :]
        blk = ((j % self.lm) == i).astype(dtype)
        return np.broadcast_to(blk, (len(self.b_rows), self.lm, self.ln)).copy()

    def densify_a(self, plan, a_re: np.ndarray, a_im: np.ndarray):
        """Scatter BSR A blocks into dense [mb*LM, mb*LM] planes (done once
        at setMatrix time; the analogue of the reference's one-time device
        upload, tfqmrgpu.cu:467-603)."""
        n = self.nr
        lm = self.lm
        dr = np.zeros((self.mb, lm, self.mb, lm), a_re.dtype)
        di = np.zeros((self.mb, lm, self.mb, lm), a_im.dtype)
        rows = np.repeat(np.arange(plan.nrows, dtype=np.int64),
                         np.diff(plan.rowptr_a))
        cols = plan.colind_a.astype(np.int64)
        dr[rows, :, cols, :] = a_re
        di[rows, :, cols, :] = a_im
        return dr.reshape(n, n), di.reshape(n, n)


def apply_mask(v: Pair, mask4: jax.Array, mb: int, lm: int, ncc: int,
               ln: int) -> Pair:
    """Zero panel positions outside the X pattern.  mask4 is [mb, 1, ncc, 1]
    in the vector dtype; XLA fuses the reshape/broadcast into the producer."""
    def m(x):
        x4 = x.reshape(mb, lm, ncc, ln)
        return (x4 * mask4).reshape(mb * lm, ncc, ln)
    return m(v[0]), m(v[1])


def make_panel_primitives(
    multiply_panel: Callable[[Pair], Pair],
    b_panel: Pair,
) -> "object":
    """Panel-form TfqmrPrimitives (single device).

    ``multiply_panel`` maps [NR, ncc, LN] pair -> [NR, ncc, LN] pair and must
    already include the X-pattern mask.
    """
    from ..core import TfqmrPrimitives

    def dotp(x: Pair, y: Pair) -> Pair:
        sdt = scalar_dtype()
        zr = jnp.sum(x[0] * y[0] - x[1] * y[1], axis=0).astype(sdt)
        zi = jnp.sum(x[0] * y[1] + x[1] * y[0], axis=0).astype(sdt)
        return zr, zi

    def nrm2(x: Pair) -> jax.Array:
        return jnp.sum(x[0] * x[0] + x[1] * x[1],
                       axis=0).astype(scalar_dtype())

    def axpy(y: Pair, x: Pair, a: Pair) -> Pair:
        ar = a[0].astype(y[0].dtype)[None]
        ai = a[1].astype(y[0].dtype)[None]
        return (ar * x[0] - ai * x[1] + y[0], ai * x[0] + ar * x[1] + y[1])

    def xpay(y: Pair, a: Pair, x: Pair) -> Pair:
        ar = a[0].astype(y[0].dtype)[None]
        ai = a[1].astype(y[0].dtype)[None]
        return (x[0] + ar * y[0] - ai * y[1], x[1] + ai * y[0] + ar * y[1])

    def add_rhs(v: Pair, b: Pair, scal) -> Pair:
        del b  # b_panel is closed over (stays device-resident)
        return (v[0] + scal * b_panel[0], v[1] + scal * b_panel[1])

    return TfqmrPrimitives(
        multiply=multiply_panel, dotp=dotp, nrm2=nrm2, axpy=axpy, xpay=xpay,
        add_rhs=add_rhs, allmax=lambda x: x, alland=lambda x: x,
    )


def dense_multiply(a_re, a_im, mask4, mb, lm, ncc, ln, precision):
    """Masked dense complex matmul: the 'dense' engine's SpMM.

    Four real matmuls with full-depth contraction (NR = mb*LM) -- the
    panel-form analogue of gemmNxNf (tfqmrgpu_blockmult.hxx:10-93).
    float64 operands run as native f64 products."""
    nr = mb * lm
    c = ncc * ln

    def multiply(x: Pair) -> Pair:
        dt = x[0].dtype
        xr = x[0].reshape(nr, c)
        xi = x[1].reshape(nr, c)
        mm = lambda u, v: jax.lax.dot(u, v, precision=precision,
                                      preferred_element_type=dt)
        yr = mm(a_re, xr) - mm(a_im, xi)
        yi = mm(a_re, xi) + mm(a_im, xr)
        y = (yr.reshape(nr, ncc, ln), yi.reshape(nr, ncc, ln))
        return apply_mask(y, mask4, mb, lm, ncc, ln)

    return multiply


def flops_dense_multiply(mb: int, lm: int, ncc: int, ln: int) -> float:
    """Dense-engine flop count (includes density waste)."""
    nr = mb * lm
    return 8.0 * nr * nr * ncc * ln
