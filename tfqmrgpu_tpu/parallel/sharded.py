"""Mesh-sharded tfQMR solve via ``shard_map``.

Runs the exact same loop body as the single-device solver
(core.tfqmr_loop) with mesh-aware primitives:

* **SpMM**: each (row, col) shard owns the pairs of its Y blocks.  The X
  working set is completed by an ``all_gather`` of the local X shards over
  the "rows" axis (the halo exchange; XLA overlaps the gather with the
  batched matmul stream), then gathered per pair and segment-summed locally.
* **dotp/nrm2**: local segmented reduction + ``psum`` over "rows".
* **scalar recurrences**: replicated per column shard ([ncmax, LN] each).
* **convergence control**: global maxima via ``pmax`` over both axes, so
  probe timing and stopping are bit-identical to the single-device solver.

The reference has no distributed layer at all (single GPU, one stream:
tfqmrgpu_handle.hxx:4-6); this module is the new-design territory called out
in SURVEY.md §5.8.

The SpMM is the single-device 'xla' engine's (gather per pair, batched
matmul, segment sum) on each shard, so this engine handles any sparsity
pattern; ``sharded_panel.ShardedPanelSolver`` is the dense-panel
alternative for small or dense operators.  ``ShardedBlockListSolver`` is
the host driver with the same ``solve`` interface as the panel solver.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import core
from ..core import TfqmrPrimitives
from ..ops import decisions
from ..ops.blocksparse import MATMUL_PRECISION
from ..ops.linalg import set_unit_blocks
from .partition import (RowPartition, partition_plan, shard_a_array,
                        shard_b_array, shard_blocks_array,
                        unshard_blocks_array)


def make_mesh(pr: int, pc: int = 1, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size < pr * pc:
        raise ValueError(f"need {pr * pc} devices, have {devices.size}")
    return Mesh(devices[: pr * pc].reshape(pr, pc), axis_names=("rows", "cols"))


def shard_devices(arr) -> list:
    """Ids of the devices that hold a shard of ``arr``."""
    return sorted({s.device.id for s in arr.addressable_shards})


def _sq(x):
    """Strip the two leading (rows, cols) shard axes inside shard_map."""
    return x.reshape(x.shape[2:])


def _sqr(x):
    """Strip one leading shard axis (arrays sharded over a single axis)."""
    return x.reshape(x.shape[1:])


@partial(jax.jit,
         static_argnames=("mesh", "nmax", "ncmax", "lm", "ln", "rhs_trivial"))
def sharded_solve_core(
    mesh: Mesh,
    a_re, a_im,            # [pr, namax+1, LM, LM]
    b_re, b_im,            # [pr, pc, nbmax, LM, LN]
    v3_re, v3_im,          # [pr, pc, nmax, LM, LN] float32
    colindx_local,         # [pr, pc, nmax] int32
    subset_local,          # [pr, pc, nbmax] int32
    pair_a, pair_xg, pair_y,  # [pr, pc, pmax] int32
    col_valid,             # [pc, ncmax] bool
    b_valid,               # [pr, pc, nbmax] bool (for trivial RHS)
    tolerance,
    max_iterations,
    *,
    nmax: int,
    ncmax: int,
    lm: int,
    ln: int,
    rhs_trivial: bool = False,
):
    """Returns (x_re, x_im [pr,pc,nmax,LM,LN], return_status, iterations,
    residuum, rhs_status [pc*ncmax, LN], n_probes)."""
    dt = a_re.dtype

    def shard_fn(a_re, a_im, b_re, b_im, v3_re, v3_im, colindx, subset,
                 pair_a, pair_xg, pair_y, col_valid, b_valid):
        a_re, a_im = _sqr(a_re), _sqr(a_im)
        b_re, b_im = _sq(b_re), _sq(b_im)
        v3 = (_sq(v3_re), _sq(v3_im))
        colindx = _sq(colindx)
        subset = _sq(subset)
        pair_a, pair_xg, pair_y = _sq(pair_a), _sq(pair_xg), _sq(pair_y)
        col_valid = _sqr(col_valid)[:, None]      # [ncmax, 1]
        b_valid = _sq(b_valid)

        axes = ("rows", "cols")

        def multiply(x):
            # halo exchange: complete the column chunk's X over the rows axis
            xg_re = jax.lax.all_gather(x[0], "rows", axis=0)
            xg_im = jax.lax.all_gather(x[1], "rows", axis=0)
            xg_re = xg_re.reshape((-1,) + xg_re.shape[2:])
            xg_im = xg_im.reshape((-1,) + xg_im.shape[2:])
            ar, ai = a_re[pair_a], a_im[pair_a]
            xr, xi = xg_re[pair_xg], xg_im[pair_xg]
            mm = lambda u, v: jax.lax.dot_general(
                u, v, (((2,), (1,)), ((0,), (0,))), preferred_element_type=dt,
                precision=MATMUL_PRECISION)
            pr_ = mm(ar, xr) - mm(ai, xi)
            pi_ = mm(ar, xi) + mm(ai, xr)
            yr = jax.ops.segment_sum(pr_, pair_y, num_segments=nmax + 1,
                                     indices_are_sorted=True)[:nmax]
            yi = jax.ops.segment_sum(pi_, pair_y, num_segments=nmax + 1,
                                     indices_are_sorted=True)[:nmax]
            return yr, yi

        sdt = decisions.scalar_dtype()

        def _dotp(x, y):
            # accumulate in the data dtype, convert per-column results to
            # f64 for the decisions (reference: col_inner in real_t)
            pr_ = jnp.sum(x[0] * y[0] - x[1] * y[1], axis=1)
            pi_ = jnp.sum(x[0] * y[1] + x[1] * y[0], axis=1)
            zr = jax.ops.segment_sum(pr_, colindx,
                                     num_segments=ncmax).astype(sdt)
            zi = jax.ops.segment_sum(pi_, colindx,
                                     num_segments=ncmax).astype(sdt)
            return (jax.lax.psum(zr, "rows"), jax.lax.psum(zi, "rows"))

        def _nrm2(x):
            p_ = jnp.sum(x[0] * x[0] + x[1] * x[1], axis=1)
            d = jax.ops.segment_sum(p_, colindx,
                                    num_segments=ncmax).astype(sdt)
            return jax.lax.psum(d, "rows")

        def _axpy(y, x, a):
            ar = a[0].astype(dt)[colindx][:, None, :]
            ai = a[1].astype(dt)[colindx][:, None, :]
            return (ar * x[0] - ai * x[1] + y[0], ai * x[0] + ar * x[1] + y[1])

        def _xpay(y, a, x):
            ar = a[0].astype(dt)[colindx][:, None, :]
            ai = a[1].astype(dt)[colindx][:, None, :]
            return (x[0] + ar * y[0] - ai * y[1], x[1] + ai * y[0] + ar * y[1])

        def _add_rhs(v, b, scal):
            # padded B slots carry zero data and point at slot 0 -> harmless
            return (v[0].at[subset].add(scal * b[0]),
                    v[1].at[subset].add(scal * b[1]))

        prim = TfqmrPrimitives(
            multiply=multiply, dotp=_dotp, nrm2=_nrm2, axpy=_axpy,
            xpay=_xpay, add_rhs=_add_rhs,
            allmax=lambda s: jax.lax.pmax(s, axes),
            alland=lambda s: jax.lax.pmin(s.astype(jnp.int32),
                                          axes).astype(bool),
        )

        # ---- RHS preparation
        if rhs_trivial:
            ub = set_unit_blocks(int(subset.shape[0]), lm, ln, dt)
            bmask = b_valid[:, None, None].astype(dt)
            v2 = (ub[0] * bmask, ub[1] * bmask)
            tau0 = jnp.where(col_valid, 1.0, 0.0).astype(sdt)
            tau0 = jnp.broadcast_to(tau0, (ncmax, ln))
            inv_bn2 = tau0
        else:
            v2 = (b_re, b_im)
            z = jnp.zeros((nmax, lm, ln), dtype=dt)
            tau0 = _nrm2(_add_rhs((z, z), v2, 1.0))
            inv_bn2 = jnp.where(col_valid & (tau0 > 0), 1.0 / jnp.where(
                tau0 > 0, tau0, 1.0), 0.0)

        z = jnp.zeros((nmax, lm, ln), dtype=dt)
        v5 = prim.add_rhs((z, z), v2, 1.0)

        result = core.tfqmr_loop(prim, v2, v3, v5, tau0, inv_bn2,
                                 tolerance, max_iterations, dt)
        # re-add the leading (rows, cols) shard axes so the out_specs
        # concatenate into the global [pr, pc, nmax, LM, LN] layout
        return (result.x[0][None, None], result.x[1][None, None],
                result.return_status, result.iterations, result.residuum,
                result.rhs_status[None], result.n_probes)

    rc = P("rows", "cols")
    r_ = P("rows")
    c_ = P("cols")
    rep = P()
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(r_, r_, rc, rc, rc, rc, rc, rc, rc, rc, rc, c_, rc),
        out_specs=(rc, rc, rep, rep, rep, c_, rep),
        check_vma=False,
    )(a_re, a_im, b_re, b_im, v3_re, v3_im, colindx_local, subset_local,
      pair_a, pair_xg, pair_y, col_valid, b_valid)


def sharded_solve(plan, part: RowPartition, mesh: Mesh, a_re, a_im,
                  b_re, b_im, tolerance: float = 1e-6,
                  max_iterations: int = 999, rhs_trivial: bool = False,
                  seed: int = core.RANDOM_SEED):
    """End-to-end sharded solve; returns (x_re, x_im global [nnzbX, LM, LN],
    result dict)."""
    from .multihost import gather_global, put_global

    lm, ln = part.lm, part.ln
    v3 = core.make_shadow_vector(plan.nnzb_x, lm, ln, seed)
    rows, rc, cols = P("rows"), P("rows", "cols"), P("cols")
    # operands enter as global arrays, so the same code runs when the mesh
    # spans several processes
    put = lambda arr, spec: put_global(arr, mesh, spec)
    out = sharded_solve_core(
        mesh,
        put(shard_a_array(part, np.asarray(a_re)), rows),
        put(shard_a_array(part, np.asarray(a_im)), rows),
        put(shard_b_array(part, np.asarray(b_re)), rc),
        put(shard_b_array(part, np.asarray(b_im)), rc),
        put(shard_blocks_array(part, np.asarray(v3[0])), rc),
        put(shard_blocks_array(part, np.asarray(v3[1])), rc),
        put(part.colindx_local, rc), put(part.subset_local, rc),
        put(part.pair_a, rc), put(part.pair_xg, rc), put(part.pair_y, rc),
        put(part.col_valid, cols), put(part.b_blocks >= 0, rc),
        tolerance, max_iterations,
        nmax=part.nmax, ncmax=part.ncmax, lm=lm, ln=ln,
        rhs_trivial=rhs_trivial,
    )
    x_re, x_im, status, iters, residuum, rhs_status, n_probes = out
    info = dict(return_status=int(status), iterations=int(iters),
                residuum=float(residuum), n_probes=int(n_probes),
                rhs_status=gather_global(rhs_status, mesh),
                shard_devices=shard_devices(x_re))
    xg_re = unshard_blocks_array(part, gather_global(x_re, mesh),
                                 plan.nnzb_x)
    xg_im = unshard_blocks_array(part, gather_global(x_im, mesh),
                                 plan.nnzb_x)
    return xg_re, xg_im, info


class ShardedBlockListSolver:
    """Host driver of the sharded block-list engine over a (rows, cols)
    mesh, with the ``solve`` interface of ``ShardedPanelSolver``."""

    def __init__(self, plan, mesh, precision: str = "c"):
        self.plan = plan
        self.mesh = mesh
        self.pr = mesh.shape["rows"]
        self.pc = mesh.shape["cols"]
        self.part = partition_plan(plan, self.pr, self.pc)
        self._part_x = None           # partition with B on X's pattern
        self.npdt = np.float64 if precision == "z" else np.float32

    def _xshaped_partition(self):
        if self._part_x is None:
            px = dataclasses.replace(
                self.plan, subset=np.arange(self.plan.nnzb_x,
                                            dtype=np.uint32),
                nnzb_b=self.plan.nnzb_x)
            self._part_x = (px, partition_plan(px, self.pr, self.pc))
        return self._part_x

    def solve(self, a_re, a_im, b_re, b_im, tolerance=1e-6,
              max_iterations=999, rhs_trivial=False, rhs_xshaped=False):
        """``rhs_xshaped=True`` takes the RHS as X-shaped blocks
        [nnzbX, LM, LN] (mixed-refinement correction solves).  Returns
        (x complex [nnzbX, LM, LN], info dict)."""
        plan, part = ((self._xshaped_partition()) if rhs_xshaped
                      else (self.plan, self.part))
        c = lambda v: np.asarray(v, self.npdt)
        x_re, x_im, info = sharded_solve(
            plan, part, self.mesh, c(a_re), c(a_im), c(b_re), c(b_im),
            tolerance=tolerance, max_iterations=max_iterations,
            rhs_trivial=rhs_trivial)
        return x_re + 1j * x_im, info
