"""The core tfQMR solver -- platform-independent layer L2.

Transcribes the algorithm of the reference's ``tfqmrgpu::solve``
(tfqmrgpu_core.hxx:20-335) into a single ``jax.lax.while_loop``: seven
X-shaped work vectors, per-RHS complex scalar recurrences (rho, alfa, beta,
c67, eta) and real recurrences (tau, var), a float32 random shadow vector v3,
and the adaptive convergence control that bounds the residual cheaply every
iteration (tau-based upper bound, tfqmrgpu_core.hxx:235-253) and probes the
true residual ``|A@v1 - B|`` only when the bound crosses an adaptive target
(tfqmrgpu_core.hxx:263-304).

Key departures from the reference:

* the reference synchronizes device->host EVERY iteration to take the
  convergence decision on the CPU (tfqmrgpu_core.hxx:235-236); here the whole
  loop runs on device and the host reads back only the final state;
* the loop body is written against an injectable primitive set
  (``TfqmrPrimitives``) so the single-device and the mesh-sharded solver
  (parallel/sharded.py, where dotp/nrm2 end in a psum) share one algorithm.

Iteration body (reference: tfqmrgpu_core.hxx:179-306, two half-steps):

    z35 = <v3, v5>;  dec35 -> beta, rho
    v6 = v5 + beta*v6;  v4 = v8 + beta*v4
    v9 = A @ v6;        v4 = v9 + beta*v4
    z34 = <v3, v4>;  dec34 -> c67, alfa
    v7 = v6 + c67*v7;   v5 += alfa*v9
    d55 = |v5|^2;    decT -> c67(real), eta, var, tau
    v1 += eta*v7;       v6 += alfa*v4;   v7 = v6 + c67*v7
    v8 = A @ v6;        v5 += alfa*v8
    d55 = |v5|^2;    decT -> eta, var, tau
    v1 += eta*v7
    convergence control (bound check, optional residual probe)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .errors import Status
from .ops import decisions, linalg
from .ops.linalg import add_rhs, axpy, dotp, nrm2, set_unit_blocks, xpay

Pair = tuple[jax.Array, jax.Array]

RANDOM_SEED = 1234  # reference: fixed cuRAND seed (tfqmrgpu_linalg.hxx:793)


class SolveResult(NamedTuple):
    x: Pair                      # solution blocks ([nnzbX, LM, LN] re, im)
    return_status: jax.Array     # scalar: SUCCESS / MAX_ITERATIONS / BREAKDOWN
    iterations: jax.Array        # scalar int32: iterations needed
    residuum: jax.Array          # scalar f64: sqrt(max residual^2 reached)
    rhs_status: jax.Array        # int32[nCols, LN] per-RHS status
    n_probes: jax.Array          # scalar int32 (for flop accounting)
    tau: jax.Array               # f64[nCols, LN] final squared-norm recurrence


@dataclasses.dataclass(frozen=True)
class TfqmrPrimitives:
    """The operations the loop body needs, pre-bound to index tables.

    ``allmax``/``alland`` reduce over whatever extra parallel axes exist
    (identity on a single device, pmax/all-reduce under shard_map)."""

    multiply: Callable[[Pair], Pair]          # y = A @ x
    dotp: Callable[[Pair, Pair], Pair]        # per-column <x, y>  (f64)
    nrm2: Callable[[Pair], jax.Array]         # per-column |x|^2   (f64)
    axpy: Callable[[Pair, Pair, Pair], Pair]  # y + a[col]*x
    xpay: Callable[[Pair, Pair, Pair], Pair]  # x + a[col]*y   (y, a, x)
    add_rhs: Callable[[Pair, Pair, float], Pair]
    allmax: Callable[[jax.Array], jax.Array]
    alland: Callable[[jax.Array], jax.Array]


@dataclasses.dataclass(frozen=True)
class _Carry:
    it: Any
    v1: Any; v4: Any; v5: Any; v6: Any; v7: Any; v8: Any
    rho: Any; eta: Any
    tau: Any; var: Any
    status: Any
    target_bound2: Any
    residual2: Any
    stop_code: Any        # 0 running, 1 converged, 2 breakdown
    iters_needed: Any
    n_probes: Any


jax.tree_util.register_dataclass(
    _Carry,
    data_fields=[f.name for f in dataclasses.fields(_Carry)],
    meta_fields=[],
)


def make_shadow_vector(nnzb_x: int, lm: int, ln: int,
                       seed: int = RANDOM_SEED) -> Pair:
    """The random shadow vector v3 -- uniform float32, fixed seed
    (reference: create_random_numbers, tfqmrgpu_linalg.hxx:777-806)."""
    key = jax.random.PRNGKey(seed)
    v = jax.random.uniform(key, (2, nnzb_x, lm, ln), dtype=jnp.float32)
    return v[0], v[1]


def tfqmr_loop(
    prim: TfqmrPrimitives,
    v2: Pair,               # B blocks (local shard)
    v3: Pair,               # shadow vector (float32, local shard)
    v5_init: Pair,          # B scattered into X shape
    tau0: jax.Array,        # f64[nCols, LN] initial squared norms of B
    inv_bn2: jax.Array,     # f64[nCols, LN] 1/|B|^2 (0 in padded slots)
    tolerance,
    max_iterations,
    dt,
) -> SolveResult:
    """The tfQMR while_loop, generic over the primitive set."""
    f64 = decisions.scalar_dtype()
    tol2 = jnp.asarray(tolerance, f64) ** 2
    maxit = jnp.asarray(max_iterations, jnp.int32)
    ncols, ln = tau0.shape

    def czeros_like(v):
        # vectors are opaque pytrees: (re, im) pairs in the block-list and
        # panel engines, single fused arrays in the pairs engine
        return jax.tree_util.tree_map(jnp.zeros_like, v)

    def szeros():
        z = jnp.zeros((ncols, ln), dtype=dt)
        return z, z

    carry0 = _Carry(
        it=jnp.int32(0),
        v1=czeros_like(v5_init), v4=czeros_like(v5_init), v5=v5_init,
        v6=czeros_like(v5_init), v7=czeros_like(v5_init),
        v8=czeros_like(v5_init),
        rho=(jnp.ones((ncols, ln), dtype=dt),
             jnp.zeros((ncols, ln), dtype=dt)),
        eta=szeros(),
        tau=tau0,
        var=jnp.zeros((ncols, ln), dtype=f64),
        status=jnp.zeros((ncols, ln), dtype=jnp.int32),
        target_bound2=tol2 * 100.0 * 100.0,   # init test_factor=100 (:130)
        # the reference inits to DBL_MAX/8
        residual2=jnp.asarray(decisions.initial_residual2(), f64),
        stop_code=jnp.int32(0),
        iters_needed=maxit,
        n_probes=jnp.int32(0),
    )

    def cond_fn(c: _Carry):
        return (c.it < maxit) & (c.stop_code == 0)

    def body_fn(c: _Carry) -> _Carry:
        it = c.it + 1
        # ---- first half-step
        z35 = prim.dotp(v3, c.v5)                          # <v3, v5>
        status, rho, beta = decisions.dec35(c.status, c.rho, z35, dt)
        v6 = prim.xpay(c.v6, beta, c.v5)                   # v6 := v5 + beta*v6
        v4 = prim.xpay(c.v4, beta, c.v8)                   # v4 := v8 + beta*v4
        v9 = prim.multiply(v6)                             # v9 := A @ v6
        v4 = prim.xpay(v4, beta, v9)                       # v4 := v9 + beta*v4
        z34 = prim.dotp(v3, v4)                            # <v3, v4>
        status, c67, alfa = decisions.dec34(status, rho, c.eta, z34, c.var, dt)
        v7 = prim.xpay(c.v7, c67, v6)                      # v7 := v6 + c67*v7
        v5_ = prim.axpy(c.v5, v9, alfa)                    # v5 += alfa*v9
        d55 = prim.nrm2(v5_)
        status, c67, eta, var, tau = decisions.dect(
            status, c.var, c.tau, alfa, d55, dt, with_c67=True)
        v1 = prim.axpy(c.v1, v7, eta)                      # v1 += eta*v7
        v6 = prim.axpy(v6, v4, alfa)                       # v6 += alfa*v4
        v7 = prim.xpay(v7, c67, v6)                        # v7 := v6 + c67*v7
        # ---- second half-step
        v8 = prim.multiply(v6)                             # v8 := A @ v6
        v5_ = prim.axpy(v5_, v8, alfa)                     # v5 += alfa*v8
        d55 = prim.nrm2(v5_)
        status, _, eta, var, tau = decisions.dect(
            status, var, tau, alfa, d55, dt, with_c67=False)
        v1 = prim.axpy(v1, v7, eta)                        # v1 += eta*v7

        # ---- convergence control (tfqmrgpu_core.hxx:235-304)
        res_ub = tau * inv_bn2
        max_bound2 = prim.allmax(jnp.max(res_ub)) * (2 * it + 1).astype(f64)
        broke = (status == -1) | (status == -2)
        all_broke = prim.alland(jnp.all(broke))
        probe = ((max_bound2 <= c.target_bound2) | (it >= maxit)) & ~all_broke
        stop_code = jnp.where(all_broke, jnp.int32(2), c.stop_code)

        def do_probe(op):
            status, tb2, res2_old, stop, itn, npr = op
            y = prim.multiply(v1)                          # v9 := A @ v1
            y = prim.add_rhs(y, v2, -1.0)                  # v9 -= B
            res2 = prim.nrm2(y) * inv_bn2
            # underflow guard (1.4e-76 in the reference)
            max_res2 = jnp.maximum(prim.allmax(jnp.max(res2)),
                                   decisions.residual_floor())
            # isDone evaluated with the status BEFORE the res2<=0 update,
            # matching the reference's loop (tfqmrgpu_core.hxx:276-286)
            is_done = prim.alland(jnp.all((res2 <= tol2) | (status != 0)))
            status = jnp.where(res2 <= 0, jnp.int32(1), status)
            tb2 = (max_bound2 / max_res2) * tol2
            stop = jnp.where(is_done, jnp.int32(1), stop)
            itn = jnp.where(is_done, it, itn)
            return status, tb2, max_res2, stop, itn, npr + 1

        status, target_bound2, residual2, stop_code, iters_needed, n_probes = \
            jax.lax.cond(
                probe, do_probe, lambda op: op,
                (status, c.target_bound2, c.residual2, stop_code,
                 c.iters_needed, c.n_probes),
            )

        return _Carry(
            it=it, v1=v1, v4=v4, v5=v5_, v6=v6, v7=v7, v8=v8,
            rho=rho, eta=eta, tau=tau, var=var, status=status,
            target_bound2=target_bound2, residual2=residual2,
            stop_code=stop_code, iters_needed=iters_needed, n_probes=n_probes,
        )

    final = jax.lax.while_loop(cond_fn, body_fn, carry0)

    return_status = jnp.where(
        final.stop_code == 1, jnp.int32(Status.SUCCESS),
        jnp.where(final.stop_code == 2, jnp.int32(Status.BREAKDOWN),
                  jnp.int32(Status.MAX_ITERATIONS)))
    return SolveResult(
        x=final.v1,
        return_status=return_status,
        iterations=final.iters_needed,
        residuum=jnp.sqrt(final.residual2),
        rhs_status=final.status,
        n_probes=final.n_probes,
        tau=final.tau,
    )


@partial(jax.jit, static_argnames=("ncols", "rhs_trivial", "lm", "ln"))
def solve_core(
    action,                       # pytree with .multiply (BlockSparseAction)
    v2: Pair,                     # B blocks [nnzbB, LM, LN]
    v3: Pair,                     # shadow vector (float32) [nnzbX, LM, LN]
    colindx: jax.Array,           # int32[nnzbX]
    subset: jax.Array,            # int32[nnzbB]
    tolerance,
    max_iterations,
    inv_bn2_override=None,        # f64[nCols, LN]: fixed 1/|B|^2 (restart
                                  # chunks keep the original normalization)
    *,
    ncols: int,
    lm: int,
    ln: int,
    rhs_trivial: bool = False,
) -> SolveResult:
    """Single-device entry: prepares RHS/norms and runs the loop."""
    dt = action.a_re.dtype
    nnzb_x = int(colindx.shape[0])

    prim = TfqmrPrimitives(
        multiply=action.multiply,
        dotp=lambda x, y: dotp(x, y, colindx, ncols),
        nrm2=lambda x: nrm2(x, colindx, ncols),
        axpy=lambda y, x, a: axpy(y, x, a, colindx),
        xpay=lambda y, a, x: xpay(y, a, x, colindx),
        add_rhs=lambda v, b, s: add_rhs(v, b, s, subset),
        allmax=lambda x: x,
        alland=lambda x: x,
    )

    # ---- preparation (tfqmrgpu_core.hxx:114-168)
    z = jnp.zeros((nnzb_x, lm, ln), dtype=dt)
    v5 = (z, z)
    if rhs_trivial:
        v2 = set_unit_blocks(int(subset.shape[0]), lm, ln, dt)
        v5 = prim.add_rhs(v5, v2, 1.0)
        sdt = decisions.scalar_dtype()
        tau0 = jnp.ones((ncols, ln), dtype=sdt)
        inv_bn2 = jnp.ones((ncols, ln), dtype=sdt)
    else:
        v5 = prim.add_rhs(v5, v2, 1.0)
        tau0 = prim.nrm2(v5)                 # squared column norms of B
        inv_bn2 = 1.0 / tau0
    if inv_bn2_override is not None:
        inv_bn2 = inv_bn2_override

    return tfqmr_loop(prim, v2, v3, v5, tau0, inv_bn2,
                      tolerance, max_iterations, dt)


@partial(jax.jit,
         static_argnames=("mb", "lm", "ncc", "ln", "rhs_trivial"))
def solve_core_panel(
    a_re, a_im,          # dense [NR, NR] planes of A
    b_panel: Pair,       # [NR, ncc, LN]
    v3_panel: Pair,      # [NR, ncc, LN] float32 shadow vector (masked)
    mask4,               # [mb, 1, ncc, 1] in data dtype
    tolerance,
    max_iterations,
    inv_bn2_override,    # f64[ncc, LN] or None: fixed 1/|B|^2 normalization
                         # (used by restart-based checkpoint/resume so the
                         # convergence target stays relative to the ORIGINAL
                         # right-hand side across chunks)
    *,
    mb: int,
    lm: int,
    ncc: int,
    ln: int,
    rhs_trivial: bool = False,
) -> SolveResult:
    """Dense-engine entry: vectors live as dense [NR, ncc, LN] panels
    (see ops/panel.py)."""
    from .ops import panel as panel_ops
    from .ops.blocksparse import MATMUL_PRECISION

    dt = b_panel[0].dtype
    multiply = panel_ops.dense_multiply(
        a_re, a_im, mask4, mb, lm, ncc, ln, MATMUL_PRECISION)

    prim = panel_ops.make_panel_primitives(multiply, b_panel)

    v5 = (b_panel[0], b_panel[1])
    sdt = decisions.scalar_dtype()
    if rhs_trivial:
        tau0 = jnp.ones((ncc, ln), dtype=sdt)
        inv_bn2 = jnp.ones((ncc, ln), dtype=sdt)
    else:
        tau0 = prim.nrm2(v5)
        inv_bn2 = jnp.where(tau0 > 0, 1.0 / jnp.where(tau0 > 0, tau0, 1.0),
                            0.0)
    if inv_bn2_override is not None:
        inv_bn2 = inv_bn2_override

    return tfqmr_loop(prim, b_panel, v3_panel, v5, tau0, inv_bn2,
                      tolerance, max_iterations, dt)


def flops_per_iteration(n_pairs: int, nnzb_x: int, lm: int, ln: int) -> float:
    """Analytic flop count of one tfQMR iteration (2 SpMM + 2 dotp + 2 nrm2 +
    10 axpy/xpay), matching the reference's accounting macros
    (tfqmrgpu_core.hxx:133-138)."""
    from .ops.blocksparse import flops_spmm

    return (2 * flops_spmm(n_pairs, lm, ln)
            + 2 * linalg.flops_dotp(nnzb_x, lm, ln)
            + 2 * linalg.flops_nrm2(nnzb_x, lm, ln)
            + 10 * linalg.flops_axpy(nnzb_x, lm, ln))


def flops_per_probe(n_pairs: int, nnzb_x: int, lm: int, ln: int) -> float:
    from .ops.blocksparse import flops_spmm

    return flops_spmm(n_pairs, lm, ln) + linalg.flops_nrm2(nnzb_x, lm, ln)
