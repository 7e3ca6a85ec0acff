"""High-level plan/handle-style solver API (layer L3 equivalent).

The reference exposes a 10-step C workflow (createHandle -> createPlan ->
bufferSize -> setBuffer -> setMatrix('A'/'B') -> solve -> getInfo ->
getMatrix('X') -> destroy*, see tfqmrgpu.cu:700-791).  In JAX the handle and
explicit buffer management dissolve -- XLA owns device memory and streams --
so the surviving state is the ``Solver`` object: plan + device-resident
matrices + compiled solve.  ``api.py`` layers a call-by-call C-API-parity
shim on top of this for users porting from the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import core
from .profiling import trace
from .bsr import Bsr
from .errors import Status, TfqmrgpuError, encode_status
from .ops import layout as layout_ops
from .ops import pairwalk
from .ops.decisions import scalar_dtype as decisions_scalar_dtype
from .ops import panel as panel_ops
from .ops.blocksparse import BlockSparseAction
from .plan import Plan, create_plan

# 'auto' picks 'dense' while the dense A planes fit in this many bytes
# (both planes together), or for dense-ish patterns up to 4 GB
DENSE_A_BYTE_LIMIT = int(64e6)

ENGINES = ("auto", "dense", "xla", "pairs")


def _dtype_for(precision: str):
    if precision == "z":
        if not jax.config.read("jax_enable_x64"):
            raise TfqmrgpuError(
                encode_status(Status.PRECISION_MISSMATCH),
                "'z' (complex128) precision requires jax_enable_x64; call "
                "tfqmrgpu_tpu.enable_x64() first",
            )
        return jnp.float64
    if precision == "c":
        return jnp.float32
    raise TfqmrgpuError(encode_status(Status.PRECISION_MISSMATCH),
                        f"precision must be 'z' or 'c', got {precision!r}")


def choose_engine(plan: Plan, lm: int, ln: int, precision: str) -> str:
    """The 'auto' engine: 'dense' for small or dense operators; else the
    pair-walk kernel ('pairs') on a GPU for block shapes it takes; else the
    XLA block-list engine.  Never an interpreted kernel."""
    rsize = 8 if precision == "z" else 4
    nr = plan.nrows * lm
    dense_bytes = 2 * nr * nr * rsize
    a_fill = plan.nnzb_a / max(plan.nrows ** 2, 1)
    if dense_bytes <= DENSE_A_BYTE_LIMIT or (
            a_fill >= 0.25 and dense_bytes <= int(4e9)):
        return "dense"
    if jax.default_backend() == "gpu" and pairwalk.supports(lm, ln):
        return "pairs"
    return "xla"


@dataclasses.dataclass
class SolveInfo:
    """getInfo parity (tfqmrgpu.cu:663-679)."""

    residuum_reached: float
    iterations_needed: int
    flops_performed: float
    flops_performed_all: float
    return_status: int = 0
    rhs_status: Optional[np.ndarray] = None


class Solver:
    """Block-sparse tfQMR solver for A @ X == B.

    Args:
      a, x, b: BSR operators.  A must carry square [LM, LM] blocks; B carries
        [LM, LN] blocks; X provides the solution pattern (data optional).
        B's pattern must be a subset of X's.
      precision: 'z' (complex128) or 'c' (complex64).
      engine: SpMM/vector engine:
        'dense' -- panel engine, A densified (fast for moderate mb);
        'xla'   -- block-list engine: plain-XLA gather, batched matmul and
                   segment sum over the plan's pair list;
        'pairs' -- block-list engine whose multiply is the pair-walk kernel
                   (ops/pairwalk.py; GPU only, power-of-two LM >= 16 and LN);
        'auto'  -- ``choose_engine``: 'dense' for small or dense A, else
                   'pairs' on a GPU where the kernel takes the block shape,
                   else 'xla'.
      interpret: run the 'pairs' kernel in the Pallas interpreter (tests on
        the CPU).  Without it, 'pairs' needs a GPU.
      index_offset: 0 for C-style, 1 for Fortran-style rowptr/colind.
    """

    def __init__(self, a: Bsr, x: Bsr, b: Bsr, *, precision: str = "z",
                 engine: str = "auto", index_offset: int = 0, echo: int = 0,
                 lm: int = 0, ln: int = 0, plan: Optional[Plan] = None,
                 interpret: bool = False):
        self.plan: Plan = plan if plan is not None else create_plan(
            a, x, b, index_offset=index_offset, echo=echo)
        self.precision = precision
        self.dtype = _dtype_for(precision)
        self.echo = echo
        lm = lm or a.slow_block_dim or (x.slow_block_dim or b.slow_block_dim)
        ln = ln or (b.fast_block_dim or x.fast_block_dim) or lm
        if lm < 1:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "cannot infer block dims; attach data to A/B")
        if ln < lm:
            raise TfqmrgpuError(
                encode_status(Status.UNDOCUMENTED_ERROR),
                f"LN={ln} < LM={lm}: rectangular blocks need LN >= LM")
        self.lm, self.ln = int(lm), int(ln)
        self.plan.lm, self.plan.ln = self.lm, self.ln
        self.plan.precision = precision

        if engine not in ENGINES:
            raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR),
                                f"engine must be one of {ENGINES}, "
                                f"got {engine!r}")
        if engine == "auto":
            engine = choose_engine(self.plan, self.lm, self.ln, precision)
        if engine == "pairs":
            if not pairwalk.supports(self.lm, self.ln):
                raise TfqmrgpuError(
                    encode_status(Status.UNDOCUMENTED_ERROR),
                    f"the pairs engine needs power-of-two LM >= "
                    f"{pairwalk.MIN_LM} and power-of-two LN (got LM="
                    f"{self.lm}, LN={self.ln}); use engine='xla'")
            if jax.default_backend() != "gpu" and not interpret:
                raise TfqmrgpuError(
                    encode_status(Status.UNDOCUMENTED_ERROR),
                    "the pairs engine's kernel compiles for a GPU only; on "
                    f"{jax.default_backend()!r} pass interpret=True or use "
                    "engine='xla'")
        self.engine = engine
        self.interpret = bool(interpret)
        if echo > 2:
            print(f"# engine {engine}")
        self._panel = engine == "dense"
        self._layout: Optional[panel_ops.PanelLayout] = None
        if self._panel:
            self._layout = panel_ops.PanelLayout.from_plan(self.plan)

        self._colindx = jnp.asarray(self.plan.colindx.astype(np.int32))
        self._subset = jnp.asarray(self.plan.subset.astype(np.int32))
        self._action: Optional[BlockSparseAction] = None
        self._a_panel = None          # dense A planes ('dense' engine)
        self._b: Optional[tuple] = None
        self._bn2: Optional[np.ndarray] = None
        self._x0 = None               # initial guess (engine layout)
        self._x_result = None
        self._x_override = None       # refined iterate (complex ndarray)
        self._info: Optional[SolveInfo] = None
        self._apply_a_jit = None
        v3 = core.make_shadow_vector(self.plan.nnzb_x, self.lm, self.ln)
        if self._panel:
            lay = self._layout
            self._v3 = (jnp.asarray(lay.pack_x(np.asarray(v3[0]))),
                        jnp.asarray(lay.pack_x(np.asarray(v3[1]))))
            self._mask4 = jnp.asarray(
                lay.mask[:, None, :, None].astype(
                    np.float64 if precision == "z" else np.float32))
        else:
            self._v3 = v3

        if a.data is not None:
            self.set_matrix("A", a.data)
        if b.data is not None:
            self.set_matrix("B", b.data)

    # ------------------------------------------------------------- matrices

    def set_matrix(self, var: str, val, *, trans: str = "n",
                   layout: int = layout_ops.LAYOUT_RIRIRIRI,
                   scale: float = 1.0, conjugate: bool = False):
        """Upload operator data ('A' or 'B'); accepts complex ndarrays
        [nnzb, d1, d2] or real interleaved arrays in any reference layout
        (setMatrix parity, tfqmrgpu.cu:609-621).  ``trans`` accepts the
        reference's full vocabulary 'n'/'t'/'h'/'c'/'*' (case-insensitive;
        'h'/'c' = adjoint, '*' = conjugate only, tfqmrgpu.cu:492-500), and
        an explicit ``conjugate`` flag composes with it."""
        var = var.upper()
        val = np.asarray(val)
        npdt = np.float64 if self.dtype == jnp.float64 else np.float32
        if var == "A":
            re, im = layout_ops.to_planes(
                val, self.plan.nnzb_a, self.lm, self.lm, trans=trans,
                layout=layout, scale=scale, conjugate=conjugate, dtype=npdt)
            if self._panel:
                dr, di = self._layout.densify_a(self.plan, re, im)
                self._a_panel = (jnp.asarray(dr), jnp.asarray(di))
            else:
                self._action = BlockSparseAction.from_plan(
                    self.plan, re, im, engine=self.engine, ln=self.ln,
                    interpret=self.interpret)
            self._apply_a_jit = None      # A changed: retrace B - A*X0
        elif var == "B":
            re, im = layout_ops.to_planes(
                val, self.plan.nnzb_b, self.lm, self.ln, trans=trans,
                layout=layout, scale=scale, conjugate=conjugate, dtype=npdt)
            if self._panel:
                self._b = (jnp.asarray(self._layout.pack_b(re)),
                           jnp.asarray(self._layout.pack_b(im)))
            else:
                self._b = (jnp.asarray(re), jnp.asarray(im))
            # per-(column, rhs) squared norms of B (for restart chunks)
            cols_b = self.plan.colindx[self.plan.subset.astype(np.int64)]
            bn2 = np.zeros((self.plan.ncols, self.ln))
            np.add.at(bn2, cols_b.astype(np.int64),
                      (re.astype(np.float64) ** 2
                       + im.astype(np.float64) ** 2).sum(axis=1))
            self._bn2 = bn2
        elif var == "X":
            # initial guess X0: the solver then runs on the shifted system
            # A*dX == B - A*X0 and returns X0 + dX.  (The reference always
            # starts from zero and leaves this as a ToDo,
            # tfqmrgpu_core.hxx:125 / bench_tfqmrgpu.cu:159 step 8x.)
            re, im = layout_ops.to_planes(
                val, self.plan.nnzb_x, self.lm, self.ln, trans=trans,
                layout=layout, scale=scale, conjugate=conjugate, dtype=npdt)
            if self._panel:
                self._x0 = (jnp.asarray(self._layout.pack_x(re)),
                            jnp.asarray(self._layout.pack_x(im)))
            else:
                self._x0 = (jnp.asarray(re), jnp.asarray(im))
        else:
            raise TfqmrgpuError(
                encode_status(Status.VARIABLENAME_UNKNOWN, 0, var),
                f"var={var!r}")

    def get_matrix(self, var: str = "X", *, trans: str = "n",
                   layout: Optional[int] = None,
                   conjugate: bool = False) -> np.ndarray:
        """Retrieve the solution X as a complex ndarray [nnzbX, LM, LN]
        (or reference-layout real array when ``layout`` is given);
        getMatrix parity (tfqmrgpu.cu:624-645, restricted to 'X').
        ``trans`` accepts 'n'/'t'/'h'/'c'/'*' like set_matrix."""
        if var.upper() != "X":
            raise TfqmrgpuError(
                encode_status(Status.VARIABLENAME_UNKNOWN, 0, var),
                "getMatrix supports only 'X'")
        if self._x_override is not None:
            re = np.ascontiguousarray(self._x_override.real)
            im = np.ascontiguousarray(self._x_override.imag)
        elif self._x_result is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "solve() has not been called")
        else:
            re, im = self._unpack_x(self._x_result)
        if layout is None:
            t, conj = layout_ops.resolve_transposition(trans, conjugate)
            if t == "t":
                re, im = np.swapaxes(re, 1, 2), np.swapaxes(im, 1, 2)
            if conj:
                im = -im
            return layout_ops.planes_to_complex(re, im)
        return layout_ops.from_planes(re, im, trans=trans, layout=layout,
                                      conjugate=conjugate)

    def _unpack_x(self, x_engine) -> tuple:
        """Engine-layout X vector -> (re, im) ndarrays [nnzbX, LM, LN]."""
        if self._panel:
            return (self._layout.unpack_x(np.asarray(x_engine[0])),
                    self._layout.unpack_x(np.asarray(x_engine[1])))
        return np.asarray(x_engine[0]), np.asarray(x_engine[1])

    def _solve_xshaped(self, r: np.ndarray, inv_bn2, tolerance,
                       max_iterations):
        """Solve A @ dX == r for an X-shaped complex RHS ``r`` (the
        correction step of iterative refinement), with the convergence
        normalization ``inv_bn2`` [ncols, LN].  ``r`` may be a complex
        ndarray or an (re, im) plane tuple.  Returns the raw SolveResult
        (x in engine layout); does NOT touch the solver's stored result."""
        npdt = np.float64 if self.precision == "z" else np.float32
        if isinstance(r, tuple):
            re = np.ascontiguousarray(np.asarray(r[0]).astype(npdt))
            im = np.ascontiguousarray(np.asarray(r[1]).astype(npdt))
        else:
            re = np.ascontiguousarray(r.real.astype(npdt))
            im = np.ascontiguousarray(r.imag.astype(npdt))
        if self._panel:
            b_over = (jnp.asarray(self._layout.pack_x(re)),
                      jnp.asarray(self._layout.pack_x(im)))
            return self._solve_panel(tolerance, max_iterations, False,
                                     b_override=b_over, inv_bn2=inv_bn2)
        ident = jnp.arange(self.plan.nnzb_x, dtype=jnp.int32)
        return core.solve_core(
            self.action, (jnp.asarray(re), jnp.asarray(im)), self._v3,
            self._colindx, ident, tolerance, max_iterations, inv_bn2,
            ncols=self.plan.ncols, lm=self.lm, ln=self.ln,
            rhs_trivial=False)

    # ---------------------------------------------------------------- solve

    @property
    def action(self) -> BlockSparseAction:
        if self._action is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "matrix 'A' has not been set")
        return self._action

    def solve(self, tolerance: float = 1e-6, max_iterations: int = 999,
              rhs_trivial: bool = False) -> SolveInfo:
        if self._b is None and not rhs_trivial:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "matrix 'B' has not been set")
        with trace(f"tfq.solve.{self.engine}"):
            result = self._dispatch_solve(tolerance, max_iterations,
                                          rhs_trivial)
        return self._finish_solve(result, max_iterations)

    def _dispatch_solve(self, tolerance, max_iterations, rhs_trivial):
        if self._x0 is not None and not rhs_trivial:
            return self._solve_shifted(tolerance, max_iterations)
        if self._panel:
            return self._solve_panel(tolerance, max_iterations, rhs_trivial)
        b = self._b
        if b is None:      # trivial RHS: shape placeholder, rebuilt on device
            z = jnp.zeros((self.plan.nnzb_b, self.lm, self.ln), self.dtype)
            b = (z, z)
        return core.solve_core(
            self.action, b, self._v3, self._colindx, self._subset,
            tolerance, max_iterations,
            ncols=self.plan.ncols, lm=self.lm, ln=self.ln,
            rhs_trivial=rhs_trivial,
        )

    def _apply_a(self, x_vec):
        """y = A @ x in the engine's vector layout (used for B - A*X0)."""
        if self.engine == "dense":
            lay = self._layout
            from .ops.panel import dense_multiply
            from .ops.blocksparse import MATMUL_PRECISION

            mult = dense_multiply(self._a_panel[0], self._a_panel[1],
                                  self._mask4, lay.mb, lay.lm, lay.ncc,
                                  lay.ln, MATMUL_PRECISION)
            return mult(x_vec)
        return self.action.multiply(x_vec)

    def _solve_shifted(self, tolerance, max_iterations):
        """Restart solve from the stored initial guess X0:
        solve A*dX == (B - A*X0) with the ORIGINAL |B| normalization, then
        return X0 + dX."""
        x0 = self._x0
        sdt = decisions_scalar_dtype()
        bn2 = jnp.asarray(self._bn2.astype(np.float64))
        inv = jnp.where(bn2 > 0, 1.0 / jnp.where(bn2 > 0, bn2, 1.0),
                        0.0).astype(sdt)
        # cache the jitted B - A*X0 operator: a fresh jax.jit wrapper per
        # restart would retrace it for every chunk
        if getattr(self, "_apply_a_jit", None) is None:
            self._apply_a_jit = jax.jit(self._apply_a)
        ax0 = self._apply_a_jit(x0)
        if self._panel:
            bp = (self._b[0] - ax0[0], self._b[1] - ax0[1])
            result = self._solve_panel(tolerance, max_iterations, False,
                                       b_override=bp, inv_bn2=inv)
            x = (result.x[0] + x0[0], result.x[1] + x0[1])
        else:
            # block-list engine: the shifted RHS is X-shaped; reuse
            # solve_core with an identity subset
            bp = (jnp.asarray(self._scatter_b()[0]) - ax0[0],
                  jnp.asarray(self._scatter_b()[1]) - ax0[1])
            ident = jnp.arange(self.plan.nnzb_x, dtype=jnp.int32)
            result = core.solve_core(
                self.action, bp, self._v3, self._colindx, ident,
                tolerance, max_iterations, inv,
                ncols=self.plan.ncols, lm=self.lm, ln=self.ln,
                rhs_trivial=False)
            x = (result.x[0] + x0[0], result.x[1] + x0[1])
        return result._replace(x=x)

    def _scatter_b(self):
        """B blocks scattered into X shape (host helper, xla engine)."""
        re = np.zeros((self.plan.nnzb_x, self.lm, self.ln),
                      np.float64 if self.precision == "z" else np.float32)
        im = np.zeros_like(re)
        sub = self.plan.subset.astype(np.int64)
        np.add.at(re, sub, np.asarray(self._b[0]))
        np.add.at(im, sub, np.asarray(self._b[1]))
        return re, im

    def _finish_solve(self, result, max_iterations) -> SolveInfo:
        self._x_result = result.x
        self._x_override = None
        iters = int(result.iterations)
        n_probes = int(result.n_probes)
        status = int(result.return_status)
        actual_iters = iters if status == int(Status.SUCCESS) else \
            min(int(max_iterations), iters)
        if self._panel:
            from .ops.panel import flops_dense_multiply
            from .ops.linalg import flops_axpy, flops_dotp, flops_nrm2

            lay = self._layout
            nb_panel = lay.mb * lay.ncc       # panel positions incl. zeros
            spmm = flops_dense_multiply(lay.mb, lay.lm, lay.ncc, lay.ln)
            per_iter = (2 * spmm
                        + 2 * flops_dotp(nb_panel, lay.lm, lay.ln)
                        + 2 * flops_nrm2(nb_panel, lay.lm, lay.ln)
                        + 10 * flops_axpy(nb_panel, lay.lm, lay.ln))
            per_probe = spmm + flops_nrm2(nb_panel, lay.lm, lay.ln)
            flops = actual_iters * per_iter + n_probes * per_probe
        else:
            flops = (actual_iters * core.flops_per_iteration(
                         self.plan.n_pairs, self.plan.nnzb_x, self.lm, self.ln)
                     + n_probes * core.flops_per_probe(
                         self.plan.n_pairs, self.plan.nnzb_x, self.lm,
                         self.ln))
        self.plan.residuum_reached = float(result.residuum)
        self.plan.iterations_needed = actual_iters
        self.plan.flops_performed = flops
        self.plan.flops_performed_all += flops
        self._info = SolveInfo(
            residuum_reached=float(result.residuum),
            iterations_needed=actual_iters,
            flops_performed=flops,
            flops_performed_all=self.plan.flops_performed_all,
            return_status=status,
            rhs_status=np.asarray(result.rhs_status),
        )
        return self._info

    def _solve_panel(self, tolerance, max_iterations, rhs_trivial,
                     b_override=None, inv_bn2=None):
        if self._a_panel is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "matrix 'A' has not been set")
        lay = self._layout
        npdt = np.float64 if self.precision == "z" else np.float32
        if b_override is not None:
            b = b_override
        elif rhs_trivial:
            unit = lay.unit_b_blocks(npdt)
            b = (jnp.asarray(lay.pack_b(unit)),
                 jnp.asarray(lay.pack_b(np.zeros_like(unit))))
        else:
            b = self._b
        a_re, a_im = self._a_panel
        return core.solve_core_panel(
            a_re, a_im, b, self._v3, self._mask4,
            tolerance, max_iterations, inv_bn2,
            mb=lay.mb, lm=lay.lm, ncc=lay.ncc, ln=lay.ln,
            rhs_trivial=rhs_trivial)

    def solve_checkpointed(self, tolerance: float = 1e-6,
                           max_iterations: int = 999, chunk: int = 50,
                           state_path: Optional[str] = None) -> SolveInfo:
        """Chunked solve with restart-based checkpointing.

        Runs the solver in chunks of ``chunk`` iterations; after each chunk
        the current iterate X is (optionally) persisted to ``state_path``
        and re-injected as the initial guess of the next chunk.  A process
        that dies mid-solve resumes by calling this again with the same
        ``state_path``.  Restarting discards the Krylov space, so total
        iterations can exceed a single uninterrupted solve -- this is the
        price of bounded recovery time.  The convergence target stays
        relative to the ORIGINAL |B| across chunks.

        (The reference has no checkpointing at all -- plans are merely
        reusable across solves, SURVEY.md §5.4.)
        """
        import os

        if state_path and not state_path.endswith(".npz"):
            state_path += ".npz"    # np.savez appends it; keep exists/remove
            # checks consistent with what savez actually wrote
        if state_path and os.path.exists(state_path):
            with np.load(state_path) as st:
                self.set_matrix("X", st["x_re"] + 1j * st["x_im"])
                done = int(st["iterations"])
        else:
            done = 0
        if done >= max_iterations:
            info = SolveInfo(
                residuum_reached=float("nan"), iterations_needed=done,
                flops_performed=0.0,
                flops_performed_all=self.plan.flops_performed_all,
                return_status=int(Status.MAX_ITERATIONS))
            self._info = info
            return info
        total = done
        info = None
        flops_total = 0.0
        while total < max_iterations:
            it = min(chunk, max_iterations - total)
            info = self.solve(tolerance=tolerance, max_iterations=it)
            total += info.iterations_needed if info.return_status == 0                 else it
            flops_total += info.flops_performed
            x = self.get_matrix("X")
            if state_path:
                np.savez(state_path, x_re=x.real, x_im=x.imag,
                         iterations=total)
            if info.return_status == int(Status.SUCCESS):
                break
            self.set_matrix("X", x)
        if info is not None:
            info.iterations_needed = total
            info.flops_performed = flops_total
        if state_path and info is not None and                 info.return_status == int(Status.SUCCESS) and                 os.path.exists(state_path):
            os.remove(state_path)
        return info

    def clear_initial_guess(self):
        """Drop the stored X0 initial guess: the next solve() starts from
        zero again (the reference's behavior -- it always clears v1,
        tfqmrgpu_core.hxx:125).  Needed after solve_checkpointed, which
        leaves the final iterate installed as X0 for resumability."""
        self._x0 = None

    def get_info(self) -> SolveInfo:
        if self._info is None:
            raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                                "solve() has not been called")
        return self._info


# ------------------------------------------------------------- one-callers

def refine_mixed(sc: Solver, a_re64: np.ndarray, a_im64: np.ndarray,
                 bx64: np.ndarray, tolerance: float, max_iterations: int,
                 info_c: SolveInfo, echo: int = 0, max_rounds: int = 12):
    """Mixed-precision iterative refinement: the 'm' core.

    Classic iterative refinement: per round, ONE f64 SpMM computes the true
    residual r = B - A@x, and the f32 engine solves the correction
    A dX == r.  Each round gains roughly the f32 engine's stall factor in
    residual until the f64 floor, so a handful of rounds reaches 'z'
    quality at f32 iteration cost.  Whether that beats a native complex128
    solve on a given card is a measurement, not a given.

    Args:
      sc: the 'c' Solver, solved once already (its iterate is the start).
      a_re64/a_im64: f64 planes of A [nnzbA, LM, LM] (for the residual op).
      bx64: B scattered into X shape, complex128 [nnzbX, LM, LN].
      info_c: the c-stage SolveInfo (iteration/flop accounting baseline).

    Returns (x complex128 [nnzbX, LM, LN], SolveInfo, converged: bool).
    """
    from .ops.blocksparse import BlockSparseAction
    from .refine import refinement_loop

    plan = sc.plan
    act = BlockSparseAction.from_plan(plan, a_re64, a_im64, engine="xla",
                                      ln=sc.ln)
    apply64 = jax.jit(lambda xr, xi: act.multiply((xr, xi)))
    bn2 = sc._bn2
    if bn2 is None:
        raise TfqmrgpuError(encode_status(Status.NO_INFO_PASSED),
                            "matrix 'B' has not been set")

    def _correction(r, res2, stall, inner_max):
        inv_r = np.where(res2 > 0, 1.0 / np.where(res2 > 0, res2, 1.0), 0.0)
        result = sc._solve_xshaped(r, jnp.asarray(inv_r), stall, inner_max)
        dre, dim = sc._unpack_x(result.x)
        inner_iters = int(result.iterations)
        if int(result.return_status) != int(Status.SUCCESS):
            inner_iters = inner_max
        return ((dre.astype(np.float64), dim.astype(np.float64)),
                inner_iters)

    res = refinement_loop(
        apply64=apply64, bx64=bx64,
        colindx=plan.colindx.astype(np.int64), bn2=bn2,
        x0=sc.get_matrix("X").astype(np.complex128),
        tolerance=tolerance, max_iterations=max_iterations,
        total_iters=info_c.iterations_needed,
        inner_base=info_c.iterations_needed,
        solve_correction=_correction,
        stall_seed=info_c.residuum_reached,
        flops_per_round=core.flops_per_probe(plan.n_pairs, plan.nnzb_x,
                                             sc.lm, sc.ln),
        flops_per_iteration=core.flops_per_iteration(
            plan.n_pairs, plan.nnzb_x, sc.lm, sc.ln),
        echo=echo, max_rounds=max_rounds, label="refine")

    info = SolveInfo(
        residuum_reached=res["ratio"],
        iterations_needed=res["total_iters"],
        flops_performed=info_c.flops_performed + res["flops"],
        flops_performed_all=sc.plan.flops_performed_all,
        return_status=int(Status.SUCCESS) if res["converged"]
        else int(Status.MAX_ITERATIONS),
    )
    return res["x"], info, res["converged"]


def _scatter_to_x(plan, b_data: np.ndarray, lm: int, ln: int) -> np.ndarray:
    """B blocks [nnzbB, LM, LN] -> X-shaped complex128 [nnzbX, LM, LN]."""
    bx = np.zeros((plan.nnzb_x, lm, ln), np.complex128)
    np.add.at(bx, plan.subset.astype(np.int64),
              np.asarray(b_data, np.complex128))
    return bx


def solve_mixed(a: Bsr, x: Bsr, b: Bsr, *, tolerance: float = 1e-9,
                max_iterations: int = 999, c_tolerance: float = 1e-4,
                engine: str = "auto", index_offset: int = 0,
                echo: int = 0) -> tuple[Bsr, SolveInfo]:
    """Mixed precision ('m'): iterate in complex64, then reach f64
    residuals by iterative refinement (one f64 SpMM per round + f32
    correction solves, see ``refine_mixed``).  Falls back to
    a complex128 re-solve from the refined iterate only if refinement
    stalls.  The reference DECLARES this mode but never enabled it
    (tfqmrgpu.cu:42 "mixed precision is still buggy"); here it is the
    way to get f64 residuals at f32 iteration cost.
    """
    if not jax.config.read("jax_enable_x64"):
        from . import enable_x64

        enable_x64()
    sc = Solver(a, x, b, precision="c", engine=engine,
                index_offset=index_offset, echo=echo)
    # bound the c-stage budget: when f32 stalls above c_tolerance (rounding
    # floor ~ cond(A)*eps_f32), burning the whole budget here is waste --
    # refinement only needs a decent initial iterate
    maxit_c = min(max_iterations, max(150, max_iterations // 4))
    info_c = sc.solve(tolerance=max(c_tolerance, tolerance),
                      max_iterations=maxit_c)

    from .ops import layout as lops

    a_re64, a_im64 = lops.complex_to_planes(a.data, np.float64)
    bx64 = _scatter_to_x(sc.plan, b.data, sc.lm, sc.ln)
    xm, info, converged = refine_mixed(sc, a_re64, a_im64, bx64, tolerance,
                                       max_iterations, info_c, echo=echo)
    if echo > 0:
        print(f"# mixed: {info_c.iterations_needed} c-iterations + "
              f"{info.iterations_needed - info_c.iterations_needed} "
              f"refine-iterations -> residuum {info.residuum_reached:.3e}"
              f"{'' if converged else ' (stalled)'}")
    if not converged and info.iterations_needed < max_iterations:
        # guarantee 'z' quality: finish with a complex128 solve restarted
        # from the refined iterate
        sz = Solver(a, x, b, precision="z", engine=engine,
                    index_offset=index_offset, echo=echo)
        sz.set_matrix("X", xm)
        info_z = sz.solve(tolerance=tolerance,
                          max_iterations=max_iterations
                          - info.iterations_needed)
        info_z.iterations_needed += info.iterations_needed
        info_z.flops_performed += info.flops_performed
        return x.with_data(sz.get_matrix("X")), info_z
    return x.with_data(xm), info


def solve(a: Bsr, x: Bsr, b: Bsr, *, precision: str = "z",
          tolerance: float = 1e-6, max_iterations: int = 999,
          engine: str = "auto", index_offset: int = 0,
          echo: int = 0) -> tuple[Bsr, SolveInfo]:
    """One-call convenience: returns (X with data attached, SolveInfo).
    The analogue of tfqmrgpu::tfqmrgpu_bsrsv (tfqmrgpu.cu:700-791).
    precision 'm' runs the mixed c-iterate/z-refine pipeline."""
    if precision == "m":
        return solve_mixed(a, x, b, tolerance=tolerance,
                           max_iterations=max_iterations, engine=engine,
                           index_offset=index_offset, echo=echo)
    s = Solver(a, x, b, precision=precision, engine=engine,
               index_offset=index_offset, echo=echo)
    info = s.solve(tolerance=tolerance, max_iterations=max_iterations)
    return x.with_data(s.get_matrix("X")), info


def bsrsv(a: Bsr, x: Bsr, b: Bsr, *, precision: str = "z",
          tolerance: float = 1e-6, max_iterations: int = 999,
          index_offset: int = 0, echo: int = 0):
    return solve(a, x, b, precision=precision, tolerance=tolerance,
                 max_iterations=max_iterations, index_offset=index_offset,
                 echo=echo)


def bsrsv_z(a, x, b, **kw):
    """complex128 one-call solve (reference: tfqmrgpu_bsrsv_z,
    tfqmrgpu.cu:796-809)."""
    kw.setdefault("precision", "z")
    return bsrsv(a, x, b, **kw)


def bsrsv_c(a, x, b, **kw):
    """complex64 one-call solve (reference: tfqmrgpu_bsrsv_c,
    tfqmrgpu.cu:812-822)."""
    kw.setdefault("precision", "c")
    return bsrsv(a, x, b, **kw)


def bsrsv_m(a, x, b, **kw):
    """mixed-precision one-call solve: c iterations + z refinement (the
    reference's declared-but-disabled 'm' mode, tfqmrgpu.cu:42)."""
    kw.setdefault("precision", "m")
    return bsrsv(a, x, b, **kw)
