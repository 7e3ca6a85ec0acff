"""Call-by-call C-API-parity layer (the reference's 20-function surface).

The reference exposes a plan-based C API (tfqmrgpu.h:16-156) with opaque
handle/plan pointers, status-code returns, and a fixed 10-step default
workflow (tfqmrgpu.cu:700-791):

    createHandle -> setStream -> createPlan -> bufferSize -> createWorkspace
    -> setBuffer -> setMatrix('A'/'B') -> solve -> getInfo -> getMatrix('X')
    -> destroy*

This module reproduces that workflow one-to-one so a user (or a foreign-
language binding -- see ``native/``) can drive the JAX solver with the same
call sequence.  Handles and plans are small integer ids into module-level
registries; every function RETURNS a packed ``tfqmrgpuStatus_t`` (0 success,
reference encoding: code + 1000*line + 10^7*char, tfqmrgpu.h:179-181) instead
of raising, and writes results through returned values (Python) that the C
bridge copies into out-pointers.

Semantics that differ from the reference (documented departures):
  * ``setStream``/``getStream`` store the value for parity; XLA owns streams.
  * ``bufferSize`` returns the analytic device-memory estimate
    (Plan.memory_requirement_bytes); XLA allocates for real, so
    ``createWorkspace`` hands out an opaque token rather than device memory
    and ``setBuffer`` performs the state setup the reference does there
    (shadow-vector generation, index-table upload).
  * precision 'm' (mixed) runs the REAL mixed pipeline: complex64
    iterations + f64-residual iterative refinement
    (solver.refine_mixed), with a complex128 re-solve fallback -- the mode
    the reference declares but disables (tfqmrgpu.cu:42).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from . import allowed_block_sizes as _allowed_block_sizes
from .bsr import Bsr
from .errors import Status, TfqmrgpuError, encode_status, get_error_string
from .ops import layout as layout_ops
from .plan import Plan, create_plan
from .solver import Solver

SUCCESS = int(Status.SUCCESS)

_ids = itertools.count(1)
_HANDLES: Dict[int, "_Handle"] = {}
_PLANS: Dict[int, "_PlanState"] = {}


@dataclass
class _Handle:
    """All library state besides plans -- mirrors tfq_handle_t
    (tfqmrgpu_handle.hxx:4-6), where the entire handle is one stream id."""

    stream: int = 0


@dataclass
class _PlanState:
    plan: Plan
    echo: int = 0
    lm: int = 0
    ln: int = 0
    precision: str = "?"
    buffer_token: int = 0          # 0 = setBuffer not called yet
    solver: Optional[Solver] = None
    solver_z: Optional[Solver] = None   # refine stage of the mixed 'm' path
    pending: Dict[str, Any] = field(default_factory=dict)  # matrices set
    raw: Dict[str, Any] = field(default_factory=dict)      # host copies for 'm'
    bsr_a: Optional[Bsr] = None
    bsr_x: Optional[Bsr] = None
    bsr_b: Optional[Bsr] = None


def _catch(fn):
    """Convert TfqmrgpuError raises into packed status returns."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except TfqmrgpuError as e:
            return e.status
        except KeyError:
            return encode_status(Status.POINTER_INVALID)
    return wrapper


# --------------------------------------------------------------- error API

def print_error(status: int) -> int:
    """tfqmrgpuPrintError (tfqmrgpu_error_tool.cxx:67-77)."""
    print(f"tfqmrgpu status {int(status)}: {get_error_string(status)}")
    return SUCCESS


# ------------------------------------------------------------- handle mgmt

def create_handle() -> tuple[int, int]:
    """tfqmrgpuCreateHandle -> (status, handle_id)."""
    hid = next(_ids)
    _HANDLES[hid] = _Handle()
    return SUCCESS, hid


def destroy_handle(handle: int) -> int:
    if _HANDLES.pop(int(handle), None) is None:
        return encode_status(Status.POINTER_INVALID)
    return SUCCESS


def set_stream(handle: int, stream: int) -> int:
    """Stored for parity; XLA owns the execution stream."""
    h = _HANDLES.get(int(handle))
    if h is None:
        return encode_status(Status.POINTER_INVALID)
    h.stream = int(stream)
    return SUCCESS


def get_stream(handle: int) -> tuple[int, int]:
    h = _HANDLES.get(int(handle))
    if h is None:
        return encode_status(Status.POINTER_INVALID), 0
    return SUCCESS, h.stream


# ---------------------------------------------------------- workspace mgmt

_WORKSPACES: Dict[int, int] = {}


def create_workspace(size_in_bytes: int, mem_type: str = "d") -> tuple[int, int]:
    """tfqmrgpuCreateWorkspace parity (tfqmrgpu.cu:682-694).  XLA owns device
    memory, so the returned value is an opaque nonzero token."""
    del mem_type
    token = next(_ids)
    _WORKSPACES[token] = int(size_in_bytes)
    return SUCCESS, token


def destroy_workspace(token: int) -> int:
    if _WORKSPACES.pop(int(token), None) is None:
        return encode_status(Status.POINTER_INVALID)
    return SUCCESS


# ---------------------------------------------------------- introspection

def bsrsv_allowed_block_sizes(array_length: int = 1 << 30) -> tuple[int, int, list]:
    """tfqmrgpu_bsrsv_allowedBlockSizes -> (status, number, flat_pairs)."""
    sizes = _allowed_block_sizes()
    flat = [v for lm_ln in sizes for v in lm_ln]
    return SUCCESS, len(sizes), flat[: max(0, int(array_length))]


def bsrsv_block_size_missing(ld_a: int, ld_b: int) -> int:
    """tfqmrgpu_bsrsv_blockSizeMissing: 0 if (ldA, ldB) is in the reference's
    compiled list.  This framework traces block shapes, so any
    LN >= LM >= 1 actually solves; this mirrors the introspection only."""
    from . import block_size_missing

    return block_size_missing(int(ld_a), int(ld_b))


# ------------------------------------------------------------- plan mgmt

@_catch
def bsrsv_create_plan(
    handle: int,
    mb: int,
    rowptr_a, colind_a,
    rowptr_x, colind_x,
    rowptr_b, colind_b,
    index_offset: int = 0,
    echo: int = 0,
) -> tuple[int, int] | int:
    """tfqmrgpu_bsrsv_createPlan (tfqmrgpu.cu:136-351): the analysis step.
    Returns (status, plan_id)."""
    if int(handle) not in _HANDLES:
        return encode_status(Status.POINTER_INVALID)
    mb = int(mb)

    def as_i32(x):
        return np.ascontiguousarray(np.asarray(x, dtype=np.int32))

    a = Bsr(mb, mb, as_i32(rowptr_a), as_i32(colind_a), name="A")
    x = Bsr(mb, 0, as_i32(rowptr_x), as_i32(colind_x), name="X")
    b = Bsr(mb, 0, as_i32(rowptr_b), as_i32(colind_b), name="B")
    off = int(index_offset)
    x.ncols = int(x.colind.max(initial=off)) + 1 - off
    b.ncols = x.ncols
    plan = create_plan(a, x, b, index_offset=int(index_offset), echo=int(echo))
    pid = next(_ids)
    _PLANS[pid] = _PlanState(plan=plan, echo=int(echo),
                             bsr_a=a, bsr_x=x, bsr_b=b)
    return SUCCESS, pid


def bsrsv_destroy_plan(handle: int, plan: int) -> int:
    del handle
    if _PLANS.pop(int(plan), None) is None:
        return encode_status(Status.POINTER_INVALID)
    return SUCCESS


@_catch
def bsrsv_buffer_size(
    handle: int,
    plan: int,
    ld_a: int,
    block_dim: int,
    ld_b: int,
    rhs_block_dim: int,
    precision: str,
) -> tuple[int, int] | int:
    """tfqmrgpu_bsrsv_bufferSize (tfqmrgpu.cu:364-412): attach block-shape and
    precision info to the plan; return the device-memory estimate in bytes."""
    del handle
    ps = _PLANS[int(plan)]
    if isinstance(precision, int):
        precision = chr(precision)
    if precision not in ("c", "z", "m"):
        return encode_status(Status.PRECISION_MISSMATCH, 0, precision)
    lm, ln = int(block_dim), int(rhs_block_dim)
    if int(ld_a) != lm or int(ld_b) != ln:
        # blocks are stored unpadded; ld must equal the dim
        return encode_status(Status.UNDOCUMENTED_ERROR, 1)
    if ln < lm or lm < 1:
        return encode_status(Status.BLOCKSIZE_MISSING, 0)
    ps.lm, ps.ln, ps.precision = lm, ln, precision
    ps.plan.lm, ps.plan.ln, ps.plan.precision = lm, ln, precision
    # 'm' iterates in 'c' and refines in 'z'; report the 'z' (upper-bound)
    # footprint so callers allocating by this number are always safe
    est = "z" if precision in ("z", "m") else "c"
    return SUCCESS, ps.plan.memory_requirement_bytes(lm, ln, est)


@_catch
def bsrsv_set_buffer(handle: int, plan: int, buffer_token: int = 1) -> int:
    """tfqmrgpu_bsrsv_setBuffer (tfqmrgpu.cu:415-450): performs the state
    setup the reference does here -- builds the engine (Solver), generates the
    random shadow vector v3, and ships the index tables to the device."""
    del handle
    ps = _PLANS[int(plan)]
    if ps.lm == 0:
        return encode_status(Status.NO_INFO_PASSED, 1)
    if ps.precision in ("z", "m"):
        import jax

        if not jax.config.read("jax_enable_x64"):
            from . import enable_x64

            enable_x64()
    # 'm' (mixed) iterates in 'c' -- the refine-stage 'z' solver is built
    # lazily at solve time from the recorded host matrices
    iter_prec = "c" if ps.precision == "m" else ps.precision
    ps.solver = Solver(ps.bsr_a, ps.bsr_x, ps.bsr_b,
                       precision=iter_prec, echo=ps.echo,
                       lm=ps.lm, ln=ps.ln, plan=ps.plan)
    ps.solver_z = None
    ps.buffer_token = int(buffer_token) or 1
    for var, args in ps.pending.items():
        ps.solver.set_matrix(var, *args[:-1], **args[-1])
    ps.pending.clear()
    return SUCCESS


def bsrsv_get_buffer(handle: int, plan: int) -> tuple[int, int]:
    del handle
    ps = _PLANS.get(int(plan))
    if ps is None:
        return encode_status(Status.POINTER_INVALID), 0
    return SUCCESS, ps.buffer_token


# ------------------------------------------------------------- matrix I/O

@_catch
def bsrsv_set_matrix(
    handle: int,
    plan: int,
    var: str,
    val,
    precision: str = "?",
    ld: int = 0,
    d2: int = 0,
    trans: str = "n",
    layout: int = layout_ops.LAYOUT_RIRIRIRI,
) -> int:
    """tfqmrgpu_bsrsv_setMatrix (tfqmrgpu.cu:609-621).  ``val`` is a real
    array in the given layout or a complex [nnzb, ld, d2] array."""
    del handle
    ps = _PLANS[int(plan)]
    if isinstance(var, int):
        var = chr(var)
    if isinstance(trans, int):
        trans = chr(trans)
    if isinstance(precision, int):
        precision = chr(precision)
    ok_prec = ("?", ps.precision) + (("z", "c") if ps.precision == "m" else ())
    if precision not in ok_prec:
        return encode_status(Status.PRECISION_MISSMATCH, 2, precision)
    args = (val, {"trans": trans, "layout": layout})
    ps.raw[var.upper()] = args      # kept for the 'm' refine stage
    ps.solver_z = None              # new data invalidates a built refiner
    if ps.solver is None:
        ps.pending[var.upper()] = args
        return SUCCESS
    ps.solver.set_matrix(var, *args[:-1], **args[-1])
    return SUCCESS


@_catch
def bsrsv_get_matrix(
    handle: int,
    plan: int,
    var: str = "X",
    precision: str = "?",
    ld: int = 0,
    d2: int = 0,
    trans: str = "n",
    layout: int = layout_ops.LAYOUT_RIRIRIRI,
) -> tuple[int, np.ndarray] | int:
    """tfqmrgpu_bsrsv_getMatrix (tfqmrgpu.cu:624-645), restricted to 'X'."""
    del handle, ld, d2
    ps = _PLANS[int(plan)]
    if isinstance(var, int):
        var = chr(var)
    if isinstance(trans, int):
        trans = chr(trans)
    if isinstance(precision, int):
        precision = chr(precision)
    if ps.solver is None:
        return encode_status(Status.NO_INFO_PASSED, 3)
    ok_prec = ("?", ps.precision) + (("z", "c") if ps.precision == "m" else ())
    if precision not in ok_prec:
        return encode_status(Status.PRECISION_MISSMATCH, 4, precision)
    src = ps.solver_z if ps.solver_z is not None else ps.solver
    val = src.get_matrix(var, trans=trans, layout=layout)
    return SUCCESS, val


# ------------------------------------------------------------------ solve

@_catch
def bsrsv_solve(handle: int, plan: int, threshold: float = 1e-6,
                max_iterations: int = 999) -> int:
    """tfqmrgpu_bsrsv_solve (tfqmrgpu.cu:648-661)."""
    del handle
    ps = _PLANS[int(plan)]
    if ps.solver is None:
        return encode_status(Status.NO_INFO_PASSED, 5)
    if ps.precision == "m":
        return _solve_mixed_plan(ps, float(threshold), int(max_iterations))
    info = ps.solver.solve(tolerance=float(threshold),
                           max_iterations=int(max_iterations))
    return int(info.return_status)


def _solve_mixed_plan(ps: _PlanState, threshold: float,
                      max_iterations: int) -> int:
    """The real mixed-precision path through the plan API: iterate in 'c'
    then reach f64 residuals by iterative refinement (one f64 SpMM per
    round + f32 correction solves,
    solver.refine_mixed), with a complex128 re-solve fallback if
    refinement stalls.  Implements the mode the reference declares but
    disables (tfqmrgpu.cu:42)."""
    from .solver import refine_mixed, _scatter_to_x

    maxit_c = min(max_iterations, max(150, max_iterations // 4))
    info_c = ps.solver.solve(tolerance=max(1e-4, threshold),
                             max_iterations=maxit_c)

    # f64 views of the recorded host matrices for the residual operator
    a_args = ps.raw.get("A")
    b_args = ps.raw.get("B")
    if a_args is None or b_args is None:
        return encode_status(Status.NO_INFO_PASSED, 6)
    a_re64, a_im64 = layout_ops.to_planes(
        a_args[0], ps.plan.nnzb_a, ps.lm, ps.lm, dtype=np.float64,
        **a_args[-1])
    b_re64, b_im64 = layout_ops.to_planes(
        b_args[0], ps.plan.nnzb_b, ps.lm, ps.ln, dtype=np.float64,
        **b_args[-1])
    bx64 = _scatter_to_x(ps.plan, b_re64 + 1j * b_im64, ps.lm, ps.ln)

    xm, info, converged = refine_mixed(
        ps.solver, a_re64, a_im64, bx64, threshold, max_iterations, info_c,
        echo=ps.echo)
    status = info.return_status
    if not converged and info.iterations_needed < max_iterations:
        if ps.solver_z is None:
            ps.solver_z = Solver(ps.bsr_a, ps.bsr_x, ps.bsr_b, precision="z",
                                 echo=ps.echo, lm=ps.lm, ln=ps.ln)
            for var, args in ps.raw.items():
                ps.solver_z.set_matrix(var, *args[:-1], **args[-1])
        ps.solver_z.set_matrix("X", xm)
        info_r = info          # c-stage + refine-round totals
        info_z = ps.solver_z.solve(
            tolerance=threshold,
            max_iterations=max_iterations - info_r.iterations_needed)
        info = info_z
        info.iterations_needed += info_r.iterations_needed
        info.flops_performed += info_r.flops_performed
        status = info.return_status
    else:
        # refinement produced the solution: stash the refined complex128
        # iterate on the 'c' solver so getMatrix returns it
        ps.solver_z = None
        ps.solver._x_override = xm
    # fold stages into the shared plan stats (getInfo reads ps.plan)
    ps.plan.residuum_reached = info.residuum_reached
    ps.plan.iterations_needed = info.iterations_needed
    ps.plan.flops_performed = info.flops_performed
    return int(status)


def bsrsv_get_info(handle: int, plan: int) -> tuple[int, float, int, float, float]:
    """tfqmrgpu_bsrsv_getInfo (tfqmrgpu.cu:663-679) ->
    (status, residuum, iterations, flops, flops_all)."""
    del handle
    ps = _PLANS.get(int(plan))
    if ps is None:
        return encode_status(Status.POINTER_INVALID), -1.0, -1, -1.0, -1.0
    p = ps.plan
    return (SUCCESS, p.residuum_reached, p.iterations_needed,
            p.flops_performed, p.flops_performed_all)


# --------------------------------------------------- one-call convenience

def _bsrsv_onecall(precision: str, mb, ld_a, ld_b,
                   rowptr_a, colind_a, amat, trans_a,
                   rowptr_x, colind_x, xmat, trans_x,
                   rowptr_b, colind_b, bmat, trans_b,
                   max_iterations, threshold, index_offset, echo):
    """The full 10-step sequence (reference: tfqmrgpu::tfqmrgpu_bsrsv,
    tfqmrgpu.cu:700-791).  Returns (status, X, iterations, residual)."""
    st, h = create_handle()
    if st:
        return st, None, 0, 0.0
    try:
        out = bsrsv_create_plan(h, mb, rowptr_a, colind_a, rowptr_x, colind_x,
                                rowptr_b, colind_b, index_offset, echo)
        if isinstance(out, int):
            return out, None, 0, 0.0
        st, p = out
        try:
            out = bsrsv_buffer_size(h, p, ld_a, ld_a, ld_b, ld_b, precision)
            if isinstance(out, int):
                return out, None, 0, 0.0
            st = bsrsv_set_buffer(h, p)
            if st:
                return st, None, 0, 0.0
            st = bsrsv_set_matrix(h, p, "A", amat, precision,
                                  ld_a, ld_a, trans_a)
            if st:
                return st, None, 0, 0.0
            st = bsrsv_set_matrix(h, p, "B", bmat, precision,
                                  ld_a, ld_b, trans_b)
            if st:
                return st, None, 0, 0.0
            solve_st = bsrsv_solve(h, p, threshold, max_iterations)
            if solve_st not in (SUCCESS, int(Status.MAX_ITERATIONS)):
                return solve_st, None, 0, 0.0
            _, resid, iters, _, _ = bsrsv_get_info(h, p)
            out = bsrsv_get_matrix(h, p, "X", precision, ld_a, ld_b, trans_x)
            if isinstance(out, int):
                return out, None, iters, resid
            _, xval = out
            return solve_st, xval, iters, resid
        finally:
            bsrsv_destroy_plan(h, p)
    finally:
        destroy_handle(h)


def bsrsv_z(mb, ld_a, ld_b, rowptr_a, colind_a, amat, trans_a,
            rowptr_x, colind_x, xmat, trans_x,
            rowptr_b, colind_b, bmat, trans_b,
            max_iterations=999, threshold=1e-9, index_offset=0, echo=0):
    """tfqmrgpu_bsrsv_z (tfqmrgpu.cu:796-809): complex128 one-call solve on
    RIRIRIRI-interleaved double arrays.  Returns
    (status, X_rirri, iterations, residual)."""
    return _bsrsv_onecall("z", mb, ld_a, ld_b,
                          rowptr_a, colind_a, amat, trans_a,
                          rowptr_x, colind_x, xmat, trans_x,
                          rowptr_b, colind_b, bmat, trans_b,
                          max_iterations, threshold, index_offset, echo)


def bsrsv_c(mb, ld_a, ld_b, rowptr_a, colind_a, amat, trans_a,
            rowptr_x, colind_x, xmat, trans_x,
            rowptr_b, colind_b, bmat, trans_b,
            max_iterations=999, threshold=1e-5, index_offset=0, echo=0):
    """tfqmrgpu_bsrsv_c (tfqmrgpu.cu:812-822): complex64 one-call solve."""
    return _bsrsv_onecall("c", mb, ld_a, ld_b,
                          rowptr_a, colind_a, amat, trans_a,
                          rowptr_x, colind_x, xmat, trans_x,
                          rowptr_b, colind_b, bmat, trans_b,
                          max_iterations, threshold, index_offset, echo)


def bsrsv_m(mb, ld_a, ld_b, rowptr_a, colind_a, amat, trans_a,
            rowptr_x, colind_x, xmat, trans_x,
            rowptr_b, colind_b, bmat, trans_b,
            max_iterations=999, threshold=1e-9, index_offset=0, echo=0):
    """Mixed-precision one-call solve on double (RIRIRIRI) arrays:
    complex64 iterations + complex128 refinement.
    The mode the reference declares but never enabled (tfqmrgpu.cu:42)."""
    return _bsrsv_onecall("m", mb, ld_a, ld_b,
                          rowptr_a, colind_a, amat, trans_a,
                          rowptr_x, colind_x, xmat, trans_x,
                          rowptr_b, colind_b, bmat, trans_b,
                          max_iterations, threshold, index_offset, echo)
