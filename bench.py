"""Benchmark on one GPU: the block-SpMM and the FD solve.

Modes (``TFQ_BENCH_MODE``):

* ``spmm`` (default): the reference's ``bench_tfqmrgpu multi`` mode
  (bench_tfqmrgpu.cu:289-440).  Y = A @ X over a multiplication plan with
  the deterministic cos/sin block fill, checked against the NumPy pair walk
  (maxdev <= 1e-4 for 'c', the reference's gate, bench_tfqmrgpu.cu:414;
  <= 1e-12 for 'z', f64 round-off), timed on every engine that takes the
  shape.  The plan is ``TFQ_PLAN_FILE`` when that file exists, else the
  synthesized banded plan of the golden plan's size (the golden
  ``plan_unordered.14-287-16`` is not shipped with the repository); the
  metric name says which.
* ``fd``: the reference's FD example (``generate_fd_problem``, radius
  ``TFQ_FD_RTB``) solved in 'z' to the generator's tolerance, timed to the
  residual and checked against the dense reference (maxdev < 1e-5,
  bench_tfqmrgpu.cu:192).

Knobs: TFQ_BENCH_PREC (c|z), TFQ_BENCH_LM / TFQ_BENCH_LN (default 32/32),
TFQ_BENCH_NREP (timed repeats, default 7), TFQ_BENCH_ENGINE (auto|xla|
pairs|dense), TFQ_PLAN_FILE, TFQ_FD_RTB (default 6.75).

Every JSON line carries the device (platform, kind, count) and the card's
name and power limit.  Without a GPU the bench prints no result and exits 2.
Run from the repository root: ``python bench.py``.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_TFLOPS = 4.3  # V100 double LM=LN=32 TUNE=4 (bench_tfqmrgpu.cu:319)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(record: dict) -> None:
    from tfqmrgpu_tpu.profiling import device_record, gpu_name_and_power_limit

    record = dict(record, device=device_record(),
                  card=gpu_name_and_power_limit())
    print(json.dumps(record), flush=True)


def load_pairs():
    """(label, pair_a, pair_x, pair_y, nnzb_y, nnzb_a, nnzb_x), pairs
    sorted by Y block."""
    from tfqmrgpu_tpu.workloads import synthesized_golden_pairs

    path = os.environ.get("TFQ_PLAN_FILE", "")
    if path and os.path.exists(path):
        from tfqmrgpu_tpu.io.planfile import read_plan_file

        pf = read_plan_file(path)
        counts = np.diff(pf.starts.astype(np.int64))
        pair_y = np.repeat(pf.y_order, counts)
        order = np.argsort(pair_y, kind="stable")
        label = "plan_" + os.path.basename(path).replace(".", "_").replace(
            "-", "_")
        return (label, pf.pairs[order, 0].astype(np.int64),
                pf.pairs[order, 1].astype(np.int64),
                pair_y[order].astype(np.int64), pf.nnzb_y, pf.nnzb_a,
                pf.nnzb_x)
    return ("synthesized_golden_size",) + synthesized_golden_pairs()


def main_spmm(prec: str, lm: int, ln: int, nrep: int, engine: str) -> int:
    import jax.numpy as jnp

    from tfqmrgpu_tpu.ops.blocksparse import flops_spmm, spmm_pairs
    from tfqmrgpu_tpu.ops.pairwalk import (kernel_a, spmm_pairwalk,
                                           starts_from_pair_y, supports)
    from tfqmrgpu_tpu.profiling import time_median
    from tfqmrgpu_tpu.workloads import cos_sin_fill, pair_walk_reference

    label, pa, px, py, ny, na, nx = load_pairs()
    dt = np.float64 if prec == "z" else np.float32
    gate = 1e-12 if prec == "z" else 1e-4
    ar, ai = cos_sin_fill(na, lm, lm)
    xr, xi = cos_sin_fill(nx, lm, ln)
    ref = pair_walk_reference(ar + 1j * ai, xr + 1j * xi, pa, px, py, ny)
    scale = float(np.abs(ref).max())
    a = (jnp.asarray(ar.astype(dt)), jnp.asarray(ai.astype(dt)))
    x = (jnp.asarray(xr.astype(dt)), jnp.asarray(xi.astype(dt)))
    pa_d, px_d = (jnp.asarray(v.astype(np.int32)) for v in (pa, px))
    py_d = jnp.asarray(py.astype(np.int32))
    impls = {"xla": lambda: spmm_pairs(a, x, pa_d, px_d, py_d, ny)}
    if supports(lm, ln):
        ka = kernel_a(*a)
        st = jnp.asarray(starts_from_pair_y(py, ny))
        impls["pairs"] = lambda: spmm_pairwalk(ka, x, st, pa_d, px_d)
    if engine != "auto":
        impls = {engine: impls[engine]}
    flops = flops_spmm(len(pa), lm, ln)
    ok = True
    for name, fn in impls.items():
        y = fn()
        dev = float(np.abs(np.asarray(y[0]) + 1j * np.asarray(y[1])
                           - ref).max()) / scale
        sec = time_median(fn, repeats=nrep)
        ok &= dev <= gate
        emit({"metric": f"spmm_{label}_lm{lm}_ln{ln}_{prec}",
              "engine": name, "value": sec * 1e3,
              "unit": "ms_per_multiply", "tflops": flops / sec / 1e12,
              "vs_v100_anchor": flops / sec / 1e12 / BASELINE_TFLOPS,
              "n_pairs": len(pa), "maxdev": dev, "gate": gate,
              "gate_pass": dev <= gate})
    return 0 if ok else 1


def main_fd(engine: str, nrep: int) -> int:
    import tfqmrgpu_tpu as tq
    from tfqmrgpu_tpu.generator import generate_fd_problem

    rtb = float(os.environ.get("TFQ_FD_RTB", "6.75"))
    prob = generate_fd_problem(rtb=rtb, reference=True)
    a, b = prob.a_with_data(), prob.b_with_data()
    solver = tq.Solver(a, prob.x, b, precision="z", engine=engine)
    solver.solve(tolerance=prob.tolerance, max_iterations=2000)  # compile
    walls = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        info = solver.solve(tolerance=prob.tolerance, max_iterations=2000)
        walls.append(time.perf_counter() - t0)
    ref = prob.x_reference.astype(np.float64)
    maxdev = float(np.abs(solver.get_matrix("X") - ref).max()
                   / np.abs(ref).max())
    converged = info.return_status == 0
    emit({"metric": f"fd_solve_rtb{rtb:g}_z", "engine": solver.engine,
          "value": float(np.median(walls)) * 1e3,
          "unit": "ms_to_residual" if converged else "ms_at_iteration_cap",
          "iterations": info.iterations_needed,
          "residuum": info.residuum_reached, "tolerance": prob.tolerance,
          "converged": converged, "maxdev": maxdev,
          "gate_pass": converged and maxdev < 1e-5})
    return 0 if converged and maxdev < 1e-5 else 1


def main() -> int:
    import jax

    from tfqmrgpu_tpu.cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        log(f"# no GPU (JAX platform {jax.devices()[0].platform!r}); "
            "the bench measures the card only")
        return 2
    jax.config.update("jax_enable_x64", True)
    log(f"# compile cache {enable_compile_cache()}")
    mode = os.environ.get("TFQ_BENCH_MODE", "spmm")
    prec = os.environ.get("TFQ_BENCH_PREC", "c")
    lm = int(os.environ.get("TFQ_BENCH_LM", "32"))
    ln = int(os.environ.get("TFQ_BENCH_LN", str(lm)))
    nrep = int(os.environ.get("TFQ_BENCH_NREP", "7"))
    engine = os.environ.get("TFQ_BENCH_ENGINE", "auto")
    if mode == "spmm":
        return main_spmm(prec, lm, ln, nrep, engine)
    if mode == "fd":
        return main_fd(engine, nrep)
    log(f"# unknown TFQ_BENCH_MODE {mode!r}; spmm or fd")
    return 2


if __name__ == "__main__":
    sys.exit(main())
