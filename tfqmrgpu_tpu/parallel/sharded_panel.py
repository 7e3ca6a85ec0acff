"""Mesh-sharded PANEL solver: the dense engine over a device mesh.

The block-list sharded solver (sharded.py) mirrors the reference-shaped
data structures; this module shards the dense-panel engine instead
(ops/panel.py): vectors are dense row panels ``[NR, ncc, LN]`` and the
block-SpMM is one full-depth masked matmul.

Sharding over a (rows, cols) mesh:

* row axis: block rows of A and the panels are split into equal chunks
  (padded).  A is stored as its local row slab ``[NR_local, NR]``; the
  SpMM completes the X operand with one ``all_gather`` over "rows" (the
  halo exchange -- for a dense slab the halo is everything) and contracts
  locally.
* col axis: compressed block columns of X/B are split; columns never
  couple in tfQMR, so A is replicated over "cols" and only the
  convergence maxima cross that axis.
* dotp/nrm2: local panel column sums + ``psum`` over "rows";
  scalar recurrences replicate per column shard; convergence control uses
  global maxima so stopping is bit-identical to a single device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from .. import core
from ..core import TfqmrPrimitives
from ..ops import decisions
from ..ops.blocksparse import MATMUL_PRECISION
from .sharded import make_mesh, shard_devices  # noqa: F401


def _ceil_to(n: int, k: int) -> int:
    return -(-n // k) * k


@partial(jax.jit,
         static_argnames=("mesh", "mb_pad", "lm", "ncc_pad", "ln",
                          "rhs_trivial"))
def sharded_panel_solve_core(
    mesh,
    a_re, a_im,         # [pr, NRl, NR]  local row slabs of dense A
    b_re, b_im,         # [pr, pc, NRl, nccl, LN] B panel shards
    v3_re, v3_im,       # [pr, pc, NRl, nccl, LN] float32
    mask,               # [pr, pc, mbl, nccl]  X-pattern occupancy (f32/f64)
    col_valid,          # [pc, nccl] bool
    tolerance,
    max_iterations,
    *,
    mb_pad: int,
    lm: int,
    ncc_pad: int,
    ln: int,
    rhs_trivial: bool = False,
):
    dt = a_re.dtype
    pr = mesh.shape["rows"]
    pc = mesh.shape["cols"]
    nrl = (mb_pad // pr) * lm
    nccl = ncc_pad // pc

    def shard_fn(a_re, a_im, b_re, b_im, v3_re, v3_im, mask, col_valid):
        a_re = a_re.reshape(a_re.shape[1:])
        a_im = a_im.reshape(a_im.shape[1:])
        b = (b_re.reshape(b_re.shape[2:]), b_im.reshape(b_im.shape[2:]))
        v3 = (v3_re.reshape(v3_re.shape[2:]), v3_im.reshape(v3_im.shape[2:]))
        mask_l = mask.reshape(mask.shape[2:])      # [mbl, nccl]
        colv = col_valid.reshape(col_valid.shape[1:])[:, None]  # [nccl, 1]
        axes = ("rows", "cols")
        c_l = nccl * ln
        mask4 = mask_l[:, None, :, None].astype(dt)

        def apply_mask(v):
            def m(x):
                x4 = x.reshape(-1, lm, nccl, ln)
                return (x4 * mask4).reshape(nrl, nccl, ln)
            return m(v[0]), m(v[1])

        def multiply(x):
            # halo exchange: complete X over the rows axis, then one local
            # full-depth masked complex matmul
            xg_re = jax.lax.all_gather(x[0], "rows", axis=0, tiled=True)
            xg_im = jax.lax.all_gather(x[1], "rows", axis=0, tiled=True)
            xr = xg_re.reshape(pr * nrl, c_l)
            xi = xg_im.reshape(pr * nrl, c_l)
            mm = lambda u, v: jax.lax.dot(u, v, precision=MATMUL_PRECISION,
                                          preferred_element_type=dt)
            yr = mm(a_re, xr) - mm(a_im, xi)
            yi = mm(a_re, xi) + mm(a_im, xr)
            return apply_mask((yr.reshape(nrl, nccl, ln),
                               yi.reshape(nrl, nccl, ln)))

        sdt = decisions.scalar_dtype()

        def dotp(x, y):
            zr = jnp.sum(x[0] * y[0] - x[1] * y[1], axis=0).astype(sdt)
            zi = jnp.sum(x[0] * y[1] + x[1] * y[0], axis=0).astype(sdt)
            return (jax.lax.psum(zr, "rows"), jax.lax.psum(zi, "rows"))

        def nrm2(x):
            d = jnp.sum(x[0] * x[0] + x[1] * x[1], axis=0).astype(sdt)
            return jax.lax.psum(d, "rows")

        def axpy(y, x, a):
            ar = a[0].astype(dt)[None]
            ai = a[1].astype(dt)[None]
            return (ar * x[0] - ai * x[1] + y[0],
                    ai * x[0] + ar * x[1] + y[1])

        def xpay(y, a, x):
            ar = a[0].astype(dt)[None]
            ai = a[1].astype(dt)[None]
            return (x[0] + ar * y[0] - ai * y[1],
                    x[1] + ai * y[0] + ar * y[1])

        def add_rhs(v, bb, scal):
            del bb
            return (v[0] + scal * b[0], v[1] + scal * b[1])

        prim = TfqmrPrimitives(
            multiply=multiply, dotp=dotp, nrm2=nrm2, axpy=axpy, xpay=xpay,
            add_rhs=add_rhs,
            allmax=lambda s: jax.lax.pmax(s, axes),
            alland=lambda s: jax.lax.pmin(s.astype(jnp.int32),
                                          axes).astype(bool),
        )

        v5 = b
        if rhs_trivial:
            tau0 = jnp.where(colv, 1.0, 0.0).astype(sdt)
            tau0 = jnp.broadcast_to(tau0, (nccl, ln))
            inv_bn2 = tau0
        else:
            tau0 = prim.nrm2(v5)
            inv_bn2 = jnp.where(colv & (tau0 > 0),
                                1.0 / jnp.where(tau0 > 0, tau0, 1.0), 0.0)

        result = core.tfqmr_loop(prim, b, v3, v5, tau0, inv_bn2,
                                 tolerance, max_iterations, dt)
        return (result.x[0][None, None], result.x[1][None, None],
                result.return_status, result.iterations, result.residuum,
                result.rhs_status[None], result.n_probes)

    rc = P("rows", "cols")
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("rows"), P("rows"), rc, rc, rc, rc, rc, P("cols")),
        out_specs=(rc, rc, P(), P(), P(), P("cols"), P()),
        check_vma=False,
    )(a_re, a_im, b_re, b_im, v3_re, v3_im, mask, col_valid)


class ShardedPanelSolver:
    """Host driver: pads/partitions a plan's panel layout over the mesh."""

    def __init__(self, plan, mesh, precision: str = "c"):
        from ..ops.panel import PanelLayout

        self.plan = plan
        self.mesh = mesh
        self.pr = mesh.shape["rows"]
        self.pc = mesh.shape["cols"]
        self.lm, self.ln = plan.lm, plan.ln
        self.lay = PanelLayout.from_plan(plan)
        self.mb_pad = _ceil_to(self.lay.mb, self.pr)
        self.ncc_pad = _ceil_to(self.lay.ncc, self.pc)
        self.npdt = np.float64 if precision == "z" else np.float32

        mask = np.zeros((self.mb_pad, self.ncc_pad), np.float64)
        mask[: self.lay.mb, : self.lay.ncc] = self.lay.mask
        self.mask = self._shard_cols_rows(
            mask.reshape(self.mb_pad, 1, self.ncc_pad, 1)
        )[:, :, :, 0, :, 0]
        cv = np.zeros((self.pc, self.ncc_pad // self.pc), bool)
        cv.reshape(-1)[: self.lay.ncc] = True
        self.col_valid = cv

        v3 = core.make_shadow_vector(plan.nnzb_x, self.lm, self.ln)
        self.v3 = (self._shard_panel(self.lay.pack_x(np.asarray(v3[0]))),
                   self._shard_panel(self.lay.pack_x(np.asarray(v3[1]))))

    def _pad_panel(self, p):
        nr, ncc = self.mb_pad * self.lm, self.ncc_pad
        out = np.zeros((nr, ncc, self.ln), p.dtype)
        out[: p.shape[0], : p.shape[1]] = p
        return out

    def _shard_panel(self, p):
        """[NR, ncc, LN] -> [pr, pc, NRl, nccl, LN]."""
        p = self._pad_panel(np.asarray(p))
        nrl = p.shape[0] // self.pr
        nccl = p.shape[1] // self.pc
        return np.ascontiguousarray(
            p.reshape(self.pr, nrl, self.pc, nccl, self.ln)
            .transpose(0, 2, 1, 3, 4))

    def _unshard_panel(self, s):
        s = np.asarray(s)
        pr, pc, nrl, nccl, ln = s.shape
        p = s.transpose(0, 2, 1, 3, 4).reshape(pr * nrl, pc * nccl, ln)
        return p[: self.lay.nr, : self.lay.ncc]

    def _shard_cols_rows(self, arr):
        """[mb_pad, 1, ncc_pad, 1] -> [pr, pc, mbl, 1, nccl, 1]."""
        mbl = self.mb_pad // self.pr
        nccl = self.ncc_pad // self.pc
        return np.ascontiguousarray(
            arr.reshape(self.pr, mbl, 1, self.pc, nccl, 1)
            .transpose(0, 3, 1, 2, 4, 5))

    def _shard_a(self, dr, di):
        """dense [NR, NR] planes -> [pr, NRl, NR] row slabs (padded)."""
        nr = self.mb_pad * self.lm
        out_r = np.zeros((nr, nr), dr.dtype)
        out_i = np.zeros((nr, nr), di.dtype)
        n0 = dr.shape[0]
        out_r[:n0, :n0] = dr
        out_i[:n0, :n0] = di
        nrl = nr // self.pr
        return (out_r.reshape(self.pr, nrl, nr),
                out_i.reshape(self.pr, nrl, nr))

    def solve(self, a_blocks_re, a_blocks_im, b_blocks_re, b_blocks_im,
              tolerance=1e-6, max_iterations=999, rhs_trivial=False,
              rhs_xshaped=False):
        """``rhs_xshaped=True`` takes the RHS as X-shaped blocks
        [nnzbX, LM, LN] (mixed-refinement correction solves).  Returns
        (x complex [nnzbX, LM, LN], info dict)."""
        dr, di = self.lay.densify_a(
            self.plan, np.asarray(a_blocks_re, self.npdt),
            np.asarray(a_blocks_im, self.npdt))
        a_re, a_im = self._shard_a(dr, di)
        pack = self.lay.pack_x if rhs_xshaped else self.lay.pack_b
        b_re = self._shard_panel(pack(np.asarray(b_blocks_re, self.npdt)))
        b_im = self._shard_panel(pack(np.asarray(b_blocks_im, self.npdt)))
        out = sharded_panel_solve_core(
            self.mesh, jnp.asarray(a_re), jnp.asarray(a_im),
            jnp.asarray(b_re), jnp.asarray(b_im),
            jnp.asarray(self.v3[0]), jnp.asarray(self.v3[1]),
            jnp.asarray(self.mask.astype(self.npdt)),
            jnp.asarray(self.col_valid),
            tolerance, max_iterations,
            mb_pad=self.mb_pad, lm=self.lm, ncc_pad=self.ncc_pad,
            ln=self.ln, rhs_trivial=rhs_trivial)
        x_re, x_im, status, iters, resid, rhs_status, n_probes = out
        info = dict(return_status=int(status), iterations=int(iters),
                    residuum=float(resid), n_probes=int(n_probes),
                    rhs_status=np.asarray(rhs_status),
                    shard_devices=shard_devices(x_re))
        xp = self._unshard_panel(x_re) + 1j * self._unshard_panel(x_im)
        x_blocks = self.lay.unpack_x(xp)
        return x_blocks, info
