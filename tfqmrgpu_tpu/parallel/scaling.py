"""Weak-scaling harness for the mesh-sharded solver.

BASELINE.json requires nnz/s and iterations-to-convergence reported at
1 card / 1 host / N>=2 hosts with >=80% weak-scaling efficiency.  The
harness has two roles:

* on a simulated CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N)
  it validates that iterations are IDENTICAL across mesh shapes and measures
  the collective/padding overhead of the sharded data path;
* on several GPUs the same entry point produces the nnz/s table (the code
  path is the same; only jax.devices() changes).

It drives the sharded block-list engine (parallel/sharded.py).

Weak scaling: the problem grows with the row-shard count (block rows
proportional to pr) so per-device work stays constant.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ScalePoint:
    pr: int
    pc: int
    mb: int
    nnzb_a: int
    n_pairs: int
    iterations: int
    status: int
    wall_s: float
    nnz_mac_per_s: float
    wall_lo: float = 0.0     # fastest warm repeat
    wall_hi: float = 0.0     # slowest warm repeat
    repeats: int = 0


def _banded_problem(mb: int, lm: int, ln: int, ncols: int, halfband: int,
                    seed: int = 0):
    """Deterministic banded block problem that weak-scales with mb."""
    from ..bsr import Bsr

    rng = np.random.default_rng(seed)
    rows, cols = [0], []
    for i in range(mb):
        lo, hi = max(0, i - halfband), min(mb, i + halfband + 1)
        cols.extend(range(lo, hi))
        rows.append(len(cols))
    nnzb = len(cols)
    data = (rng.standard_normal((nnzb, lm, lm))
            + 1j * rng.standard_normal((nnzb, lm, lm)))
    rowptr = np.asarray(rows)
    for i in range(mb):
        d = rows[i] + list(cols[rows[i]:rows[i + 1]]).index(i)
        data[d] += 6.0 * (2 * halfband + 1) * lm * np.eye(lm)
    a = Bsr(mb, mb, rowptr, np.asarray(cols), data, name="A")

    x = Bsr(mb, ncols, np.arange(mb + 1) * ncols,
            np.tile(np.arange(ncols), mb), None, name="X")
    rowptr_b = np.concatenate([[0], np.cumsum(
        [1 if r < ncols else 0 for r in range(mb)])])
    b_data = (rng.standard_normal((ncols, lm, ln))
              + 1j * rng.standard_normal((ncols, lm, ln)))
    b = Bsr(mb, ncols, rowptr_b, np.arange(ncols), b_data, name="B")
    return a, x, b


def run_point(pr: int, pc: int, mb_per_shard: int = 16, lm: int = 8,
              ln: int = 8, ncols: int = 4, tolerance: float = 1e-8,
              max_iterations: int = 300, repeats: int = 3,
              seed: int = 0, fixed_iterations: int = 0) -> ScalePoint:
    """One weak-scaling measurement on a pr x pc mesh.

    ``fixed_iterations``: when > 0, run exactly that many iterations
    (unreachable tolerance) so every mesh shape does identical per-shard
    work -- weak-scaled problems otherwise converge in different iteration
    counts, and per-solve dispatch overhead amortized over a lucky long
    solve masquerades as efficiency."""
    import jax

    from ..plan import create_plan
    from . import make_mesh, partition_plan
    from .sharded import sharded_solve

    mb = mb_per_shard * pr
    a, x, b = _banded_problem(mb, lm, ln, ncols * pc, halfband=2, seed=seed)
    plan = create_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    part = partition_plan(plan, pr, pc)
    mesh = make_mesh(pr, pc)
    if fixed_iterations:
        tolerance, max_iterations = 1e-30, fixed_iterations

    times = []
    info = None
    for i in range(repeats + 1):        # extra warm-up solve (compile)
        t0 = time.perf_counter()
        _, _, info = sharded_solve(
            plan, part, mesh, a.data.real, a.data.imag,
            b.data.real, b.data.imag,
            tolerance=tolerance, max_iterations=max_iterations)
        dt = time.perf_counter() - t0
        if i:                           # discard the compile-laden first
            times.append(dt)
    best = float(np.median(times))
    iters = max(int(info["iterations"]), 1) if not fixed_iterations \
        else int(max_iterations)
    macs = plan.n_pairs * lm * lm * ln * iters
    return ScalePoint(pr=pr, pc=pc, mb=mb, nnzb_a=a.nnzb,
                      n_pairs=plan.n_pairs, iterations=iters,
                      status=int(info["return_status"]), wall_s=best,
                      nnz_mac_per_s=macs / best,
                      wall_lo=float(np.min(times)),
                      wall_hi=float(np.max(times)),
                      repeats=len(times))


def weak_scaling_report(max_devices: Optional[int] = None,
                        mb_per_shard: int = 16,
                        fixed_iterations: int = 25, **kw):
    """Measure 1, 2, ..., N row shards; report per-shard efficiency vs 1.

    Runs a FIXED iteration count per point (see run_point) so the nnz/s
    comparison is apples-to-apples across mesh shapes."""
    import jax

    n = max_devices or len(jax.devices())
    points = []
    prs = [p for p in (1, 2, 4, 8) if p <= n]
    for pr in prs:
        points.append(run_point(pr, 1, mb_per_shard=mb_per_shard,
                                fixed_iterations=fixed_iterations, **kw))
    base = points[0]
    sim = jax.default_backend() == "cpu"
    report = []
    for p in points:
        per_shard = p.nnz_mac_per_s / p.pr
        eff = per_shard / base.nnz_mac_per_s
        row = dict(pr=p.pr, mb=p.mb, iterations=p.iterations,
                   wall_s=round(p.wall_s, 4),
                   nnz_mac_per_s=p.nnz_mac_per_s,
                   efficiency=round(eff, 3))
        if sim:
            # a simulated mesh runs all "devices" on one host, so weak
            # scaling is ceiling-limited at 1/pr; normalize by that ceiling
            # to expose the sharded data path's own overhead
            row["host_normalized_efficiency"] = round(eff * p.pr, 3)
            # same-host simulation CANNOT resolve weak-scaling efficiency
            # (cache and XLA-CPU threading effects dwarf the signal), so
            # every pr>1 row is flagged unresolved
            row["resolved"] = p.pr == 1
        report.append(row)
    return report


def host_overhead_report(mb_total: int = 128, fixed_iterations: int = 25,
                         max_devices: Optional[int] = None,
                         repeats: int = 9, **kw):
    """Fixed GLOBAL problem across mesh shapes (strong comparison).

    On a simulated mesh every "device" shares one host, so the total work
    is identical at every pr and the ideal wall time is FLAT; the ratio to
    the pr=1 point isolates the sharded data path's own cost (collective
    ops, halo padding, per-shard dispatch) without the 1/pr host ceiling
    that makes weak-scaling numbers on a shared host hard to read.  On
    real hardware the same report gives strong-scaling speedup instead
    (read 1/relative_wall).

    Noise discipline: ``repeats`` warm solves per
    point (default 9), wall_s is the median, spread_pct the min..max
    range relative to it; a row whose |overhead| is below the larger of
    the two points' spreads carries resolved=False -- same-host
    simulation cannot separate signal from run-to-run variance there."""
    import jax

    n = max_devices or len(jax.devices())
    rows = []
    base = None
    base_spread = 0.0
    for pr in (1, 2, 4, 8):
        if pr > n or mb_total % pr:
            continue
        p = run_point(pr, 1, mb_per_shard=mb_total // pr,
                      fixed_iterations=fixed_iterations,
                      repeats=repeats, **kw)
        spread = 100.0 * (p.wall_hi - p.wall_lo) / max(p.wall_s, 1e-30)
        if base is None:
            base = p.wall_s
            base_spread = spread
        over = 100.0 * (p.wall_s / base - 1.0)
        rows.append(dict(pr=pr, mb=p.mb, iterations=p.iterations,
                         repeats=p.repeats,
                         wall_s=round(p.wall_s, 4),
                         wall_min_s=round(p.wall_lo, 4),
                         wall_max_s=round(p.wall_hi, 4),
                         spread_pct=round(spread, 1),
                         relative_wall=round(p.wall_s / base, 3),
                         sharding_overhead_pct=round(over, 1),
                         resolved=bool(abs(over) > max(spread,
                                                       base_spread) / 2)))
    return rows


def main(argv=None):
    import json
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "overhead":
        rep = host_overhead_report(
            mb_total=int(argv[1]) if len(argv) > 1 else 128)
    else:
        rep = weak_scaling_report(
            mb_per_shard=int(argv[0]) if argv else 16)
    for row in rep:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
