"""tfqmrgpu_tpu: a JAX block-sparse transpose-free QMR (tfQMR) framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
real-space/tfQMRgpu CUDA library: solves ``A @ X == B`` for block-sparse
complex operators in BSR format, vectorized over many right-hand sides, on
an NVIDIA GPU -- one card or sharded over a device mesh.

Layer map (equivalents of the reference's five layers):

* ``ops/``      -- device kernels: block-SpMM (XLA + a Pallas/Triton
                   pair-walk kernel), fused per-column
                   linalg (axpy/xpay/dotp/nrm2), tfQMR decision math.
* ``core.py``   -- the platform-independent tfQMR solver as a
                   ``jax.lax.while_loop`` (reference: tfqmrgpu_core.hxx).
* ``plan.py``   -- the one-time analysis step producing flat index tables
                   (reference: tfqmrgpu.cu:136-351 createPlan).
* ``api.py``    -- plan/handle-style public API incl. one-call ``bsrsv_z/_c``
                   equivalents (reference: tfqmrgpu.h).
* ``parallel/`` -- NEW territory: block-row sharding over a ``jax.sharding.Mesh``
                   with halo exchange + psum reductions (absent in reference).
* ``io/``       -- XML / legacy / pair-plan-file problem readers and writers.
* ``generator.py`` -- finite-difference example problem generator.
"""

from .errors import (
    TfqmrgpuError,
    Status,
    get_error_string,
)
from .bsr import Bsr, BlockSparseMatrix
from .plan import Plan, create_plan
from .solver import Solver, solve, solve_mixed, bsrsv, bsrsv_z, bsrsv_c, bsrsv_m
from . import ops
from . import parallel
from . import profiling
from .autotune import autotune_solver

__version__ = "0.1.0"

ALLOWED_BLOCK_SIZES = (
    # (LM, LN) pairs supported by the reference library
    # (reference: tfQMRgpu/include/allowed_block_sizes.h:4-18).  This
    # framework traces block shapes at jit time, so ANY (LM, LN) with
    # LN >= LM works; this tuple is kept for introspection parity.
    (4, 4), (4, 5), (4, 8), (4, 32),
    (8, 8), (8, 9), (8, 10), (8, 32), (8, 64),
    (16, 16), (16, 32), (16, 64),
    (32, 32), (32, 64),
    (64, 64),
)


def allowed_block_sizes():
    """Reference-parity introspection (tfqmrgpu.cu:75-90)."""
    return list(ALLOWED_BLOCK_SIZES)


def block_size_missing(ldA: int, ldB: int) -> int:
    """Returns 0 if the (ldA, ldB) block-size pair is in the reference's
    compiled list (tfqmrgpu.cu:93-106).  This framework itself accepts any
    LN >= LM >= 1."""
    return 0 if (ldA, ldB) in ALLOWED_BLOCK_SIZES else int(Status.BLOCKSIZE_MISSING)


def enable_x64():
    """Enable float64/complex128 ('z' precision) support in JAX."""
    import jax

    jax.config.update("jax_enable_x64", True)
