"""Multi-device / multi-host layer (new territory -- absent in the reference,
which is single-GPU: tfqmrgpu_handle.hxx:4-6, SURVEY.md §5.8).

Block rows of A, X and B are partitioned over the "rows" axis of a
``jax.sharding.Mesh`` and compressed block columns over its "cols" axis;
each device runs the local SpMM against an X working set completed by an
``all_gather`` over "rows", and the per-RHS segmented reductions finish
with a ``psum``.  Scalar recurrences are replicated.  Two engines:

* ``ShardedBlockListSolver`` (sharded.py): the block-list engine, any
  sparsity pattern;
* ``ShardedPanelSolver`` (sharded_panel.py): the dense-panel engine, for
  small or dense operators.
"""

from .partition import RowPartition, partition_plan
from .sharded import (ShardedBlockListSolver, sharded_solve,
                      sharded_solve_core, make_mesh)
from .sharded_panel import ShardedPanelSolver

__all__ = ["RowPartition", "partition_plan", "ShardedBlockListSolver", "sharded_solve", "sharded_solve_core",
           "make_mesh", "ShardedPanelSolver", "solve_sharded",
           "choose_sharded_engine"]

SHARDED_ENGINES = ("auto", "panel", "blocklist")


def choose_sharded_engine(plan) -> str:
    """'panel' where the single-device solver would pick 'dense' (small or
    dense A), else 'blocklist'."""
    from ..solver import choose_engine

    dense = choose_engine(plan, plan.lm, plan.ln, "c") == "dense"
    return "panel" if dense else "blocklist"


def solve_sharded(a, x, b, *, mesh=None, n_devices: int = 0,
                  engine: str = "auto", precision: str = "c",
                  tolerance: float = 1e-5, max_iterations: int = 300):
    """One-call mesh-sharded solve: returns (X blocks complex, info dict).

    The multi-device analogue of ``tfqmrgpu_tpu.solve``: builds the plan,
    shards A/X/B over a "rows" mesh (``mesh``, or ``n_devices`` by 1,
    default all local devices), and solves with a sharded engine:
    'panel', 'blocklist', or 'auto' (``choose_sharded_engine``).

    precision 'c' iterates in float32; precision 'm' additionally refines
    to f64 residuals (one f64 SpMM per round, sharded f32 correction
    solves -- see ``parallel.mixed``).  Stopping is globally synchronized
    and bit-identical to one device.
    """
    import numpy as np

    if precision not in ("c", "m"):
        raise ValueError("sharded engines iterate in float32: use "
                         "precision 'c', or 'm' for f64-residual "
                         "refinement; plain 'z' runs on one device")
    plan, sp, eng = _build_sharded(a, x, b, mesh=mesh, n_devices=n_devices,
                                   engine=engine)
    if precision == "m":
        from .mixed import solve_sharded_mixed

        xc, info = solve_sharded_mixed(
            a, x, b, plan, sp, tolerance=tolerance,
            max_iterations=max_iterations)
    else:
        xc, info = sp.solve(np.asarray(a.data.real),
                            np.asarray(a.data.imag),
                            np.asarray(b.data.real),
                            np.asarray(b.data.imag),
                            tolerance=tolerance,
                            max_iterations=max_iterations)
    info["engine"] = eng
    return xc, info


def _build_sharded(a, x, b, *, mesh=None, n_devices: int = 0,
                   engine: str = "auto"):
    """Shared plumbing of solve_sharded: plan + engine pick + solver."""
    import jax

    from ..plan import create_plan

    if engine not in SHARDED_ENGINES:
        raise ValueError(f"unknown sharded engine {engine!r}; "
                         f"one of {SHARDED_ENGINES}")
    if mesh is None:
        mesh = make_mesh(int(n_devices) or len(jax.devices()), 1)
    plan = create_plan(a, x, b)
    lm = a.slow_block_dim or b.slow_block_dim
    ln = b.fast_block_dim or lm
    plan.lm, plan.ln = int(lm), int(ln)
    eng = choose_sharded_engine(plan) if engine == "auto" else engine
    if eng == "panel":
        sp = ShardedPanelSolver(plan, mesh, precision="c")
    else:
        sp = ShardedBlockListSolver(plan, mesh, precision="c")
    return plan, sp, eng
