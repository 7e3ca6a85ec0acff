"""Block-sparse operator action  Y = A @ X  over a multiplication pair list.

This is the flop engine of the solver (~90% of the work,
reference call stack §3.2).  The contraction is

    Y[iY] = sum_{p in [starts[iY], starts[iY+1])}  A[pairs[p,0]] @ X[pairs[p,1]]

with complex LM x LM blocks of A and LM x LN blocks of X/Y
(reference: gemmNxNf, tfqmrgpu_blockmult.hxx:10-93, and the CPU oracle in
tfqmrgpu_blocksparse.hxx:142-196).

Two implementations:

* ``spmm_pairs`` (this module): plain XLA -- gather both operand blocks per
  pair, one batched complex matmul over all pairs (4 real batched matmuls,
  float64 ones go to cuBLAS as they are), then a sorted segment-sum into Y
  blocks.  Simple, differentiable, works on any backend; every per-pair
  product is written to device memory and read back by the segment sum.
* ``pairwalk.spmm_pairwalk``: the hand-written pair-walk kernel (Pallas
  through Triton) that keeps each Y block's accumulator in registers.

The ``BlockSparseAction`` class mirrors the reference's operator-abstraction
contract (blocksparse_action_t, tfqmrgpu_blocksparse.hxx:14-203): any object
with ``multiply(y, x) -> y`` and matching plan metadata can drive the solver
(user-defined operators, README.md:110-117).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

Pair = tuple[jax.Array, jax.Array]

# Matmul precision for the solver data path.  JAX's DEFAULT dot precision
# may run float32 products in TF32 (~3 decimal digits), which risks the
# reference's correctness gate (maxdev <= 1e-4 for float,
# bench_tfqmrgpu.cu:414); HIGHEST keeps true f32.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("nnzb_y",))
def spmm_pairs(
    a: Pair,            # ([nnzbA, LM, LM], [nnzbA, LM, LM])
    x: Pair,            # ([nnzbX, LM, LN], [nnzbX, LM, LN])
    pair_a: jax.Array,  # int32[nPairs]  A-block index per pair
    pair_x: jax.Array,  # int32[nPairs]  X-block index per pair
    pair_y: jax.Array,  # int32[nPairs]  Y-block index per pair (sorted asc.)
    nnzb_y: int,
) -> Pair:
    """Pure-XLA pair-list SpMM.  pair_y must be sorted ascending (it is, by
    construction of the plan) so the segment sum takes the fast sorted path."""
    ar = a[0][pair_a]
    ai = a[1][pair_a]
    xr = x[0][pair_x]
    xi = x[1][pair_x]
    dt = x[0].dtype
    mm = lambda u, v: jax.lax.dot_general(
        u, v, (((2,), (1,)), ((0,), (0,))), preferred_element_type=dt,
        precision=MATMUL_PRECISION)
    # complex product via 4 real batched matmuls (re/im planes)
    pr = mm(ar, xr) - mm(ai, xi)
    pi = mm(ar, xi) + mm(ai, xr)
    yr = jax.ops.segment_sum(pr, pair_y, num_segments=nnzb_y,
                             indices_are_sorted=True)
    yi = jax.ops.segment_sum(pi, pair_y, num_segments=nnzb_y,
                             indices_are_sorted=True)
    return yr, yi


def flops_spmm(n_pairs: int, lm: int, ln: int) -> float:
    """Reference flop model: nPairs * 8 * LM^2 * LN
    (tfqmrgpu_blocksparse.hxx:198, bench_tfqmrgpu.cu:335)."""
    return n_pairs * 8.0 * lm * lm * ln


@dataclasses.dataclass
class BlockSparseAction:
    """Default operator action: explicit block-sparse A (L1 of the layer map).

    Holds the device-resident A blocks and the plan's index tables; callable
    as ``action(x) -> y``.  ``engine`` selects the SpMM implementation:
    'xla' (gather + batched matmul + segment sum) or 'pairs' (the pair-walk
    kernel, ``ops/pairwalk.py``; ``interpret`` runs it in the Pallas
    interpreter).
    """

    a_re: jax.Array             # [nnzbA, LM, LM]
    a_im: jax.Array
    pair_a: jax.Array           # int32[nPairs]
    pair_x: jax.Array           # int32[nPairs]
    pair_y: jax.Array           # int32[nPairs]
    nnzb_y: int
    lm: int
    ln: int
    engine: str = "xla"
    interpret: bool = False
    # pair-walk kernel operands (engine == 'pairs')
    starts: Optional[jax.Array] = None   # int32[nnzbY + 1]
    ka: Optional[tuple] = None           # A planes in the kernel's layout

    @classmethod
    def from_plan(cls, plan, a_re, a_im, engine: str = "xla",
                  ln: Optional[int] = None,
                  interpret: bool = False) -> "BlockSparseAction":
        lm = int(np.asarray(a_re).shape[1])
        ln_ = int(ln if ln is not None else lm)
        if ln_ < lm:
            raise ValueError(
                f"LN={ln_} < LM={lm}: the rectangular feature only supports "
                "more columns than rows (reference: tfqmrgpu_core.hxx:34)")
        if engine not in ("xla", "pairs"):
            raise ValueError(f"unknown block-list engine {engine!r}")
        counts = np.diff(plan.starts)
        pair_y = np.repeat(np.arange(plan.nnzb_x, dtype=np.int32), counts)
        kw = dict(
            a_re=jnp.asarray(a_re), a_im=jnp.asarray(a_im),
            pair_a=jnp.asarray(plan.pairs[:, 0].astype(np.int32)),
            pair_x=jnp.asarray(plan.pairs[:, 1].astype(np.int32)),
            pair_y=jnp.asarray(pair_y),
            nnzb_y=plan.nnzb_x, lm=lm, ln=ln_, engine=engine,
            interpret=bool(interpret),
        )
        if engine == "pairs":
            from .pairwalk import kernel_a

            kw.update(starts=jnp.asarray(plan.starts.astype(np.int32)),
                      ka=kernel_a(kw["a_re"], kw["a_im"]))
        return cls(**kw)

    def multiply(self, x: Pair) -> Pair:
        if self.engine == "pairs":
            from .pairwalk import spmm_pairwalk

            return spmm_pairwalk(self.ka, x, self.starts, self.pair_a,
                                 self.pair_x, interpret=self.interpret)
        return spmm_pairs((self.a_re, self.a_im), x,
                          self.pair_a, self.pair_x, self.pair_y, self.nnzb_y)

    __call__ = multiply

    @property
    def n_pairs(self) -> int:
        return int(self.pair_a.shape[0])

    def flops_per_multiply(self) -> float:
        return flops_spmm(self.n_pairs, self.lm, self.ln)

    def has_preconditioner(self) -> bool:
        return False


jax.tree_util.register_dataclass(
    BlockSparseAction,
    data_fields=["a_re", "a_im", "pair_a", "pair_x", "pair_y", "starts",
                 "ka"],
    meta_fields=["nnzb_y", "lm", "ln", "engine", "interpret"],
)
