"""GPU smoke check: the tfQMR solver's main path, end to end, on one card.

    python chip_smoke.py            # one GPU: phases P0-P4
    python chip_smoke.py --four     # four GPUs: the mesh phase only

Phases (each raises on failure; any failure exits non-zero before the last
line is printed):

* P0  device: JAX must find a GPU; prints the JAX version, device kind and
      count, XLA_FLAGS, the compile-cache directory and the card's name and
      power limit (nvidia-smi).
* P1  the block-SpMM at the golden plan's width (synthesized banded plan,
      LM = LN = 32) in 'c' and 'z': the pair-walk kernel and the plain-XLA
      ``spmm_pairs``, each checked against the NumPy pair walk in float64,
      with its compiled memory analysis and its time per multiply.
* P2  the reference's own FD solve (``generate_fd_problem(rtb=12.75,
      reference=True)``, LM = LN = 8) through ``tq.bsrsv_z``, checked
      against the generator's dense reference solution.
* P3  full solves at the golden width (diagonally dominant A on the
      synthesized pattern) through ``tq.Solver(engine="auto")`` in 'z' and
      'c', beside the XLA block-list engine, each checked by the NumPy pair
      walk residual |A X - B| / |B|.
* P4  the GPU-only checks the test suite marks ``gpu`` (``run_gpu_checks``),
      run in this process.
* --four: the golden-width 'c' problem through ``solve_sharded`` and
      ``ShardedPanelSolver`` on meshes (4,1) and (2,2), against a
      one-device solve in the same process.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Each phase is a function with size parameters, so the CPU tests run it at
a tiny size with ``interpret=True``; the script itself refuses the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# correctness gates, each with its reason
GATE_SPMM_C = 1e-4     # the reference bench's float gate (bench_tfqmrgpu.cu:414)
GATE_SPMM_Z = 1e-12    # f64 round-off over the contraction (~1e-15 x depth);
#                        an f32-accumulating product (~1e-7) fails it
GATE_FD_MAXDEV = 1e-5  # the reference driver's gate (bench_tfqmrgpu.cu:192)
GATE_RES_Z = 1e-9      # solve tolerance 1e-10 plus the recurrence's drift
GATE_RES_C = 1e-4      # solve tolerance 1e-5 plus f32 round-off of A X
GATE_PARITY = 1e-3     # sharded vs one device: f32 sums in another order
PARITY_ITERS = 2


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------- P0

def phase_device(expect_count: int = 1) -> dict:
    import jax

    from tfqmrgpu_tpu.cache import enable_compile_cache
    from tfqmrgpu_tpu.profiling import device_record, gpu_name_and_power_limit

    dev = device_record()
    check(dev["platform"] == "gpu",
          f"P0: JAX finds no GPU (platform {dev['platform']!r})")
    check(dev["count"] >= expect_count,
          f"P0: need {expect_count} GPUs, JAX finds {dev['count']}")
    cache = enable_compile_cache()
    log(f"# P0 jax {jax.__version__}, device_kind {dev['kind']!r}, "
        f"count {dev['count']}")
    log(f"# P0 XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile cache {cache}")
    log(f"# P0 nvidia-smi: {gpu_name_and_power_limit() or 'unavailable'}")
    return dev


# ---------------------------------------------------------------- P1

def _planes(re, im, dtype):
    import jax.numpy as jnp

    return jnp.asarray(re.astype(dtype)), jnp.asarray(im.astype(dtype))


def phase_multiply(mb: int = 281, ncols: int = 16, deg: int = 11,
                   lm: int = 32, ln: int = 32, *, interpret: bool = False,
                   repeats: int = 7) -> list:
    """The pair-walk kernel and plain XLA against the NumPy pair walk."""
    import jax
    import jax.numpy as jnp

    from tfqmrgpu_tpu.ops.blocksparse import flops_spmm, spmm_pairs
    from tfqmrgpu_tpu.ops.pairwalk import kernel_a, spmm_pairwalk
    from tfqmrgpu_tpu.profiling import time_median
    from tfqmrgpu_tpu.workloads import (cos_sin_fill, pair_walk_reference,
                                        synthesized_golden_pairs)

    pa, px, py, ny, na, nx = synthesized_golden_pairs(mb, ncols, deg)
    ar, ai = cos_sin_fill(na, lm, lm)
    xr, xi = cos_sin_fill(nx, lm, ln)
    t0 = time.perf_counter()
    ref = pair_walk_reference(ar + 1j * ai, xr + 1j * xi, pa, px, py, ny)
    log(f"# P1 synthesized plan: {mb} block rows x {deg} A blocks, {ncols} "
        f"RHS block columns, {len(pa)} pairs, LM={lm} LN={ln}; NumPy pair "
        f"walk {time.perf_counter() - t0:.2f} s")
    scale = float(np.abs(ref).max())
    pa_d = jnp.asarray(pa.astype(np.int32))
    px_d = jnp.asarray(px.astype(np.int32))
    py_d = jnp.asarray(py.astype(np.int32))
    starts = jnp.asarray(np.searchsorted(py, np.arange(ny + 1))
                         .astype(np.int32))
    flops = flops_spmm(len(pa), lm, ln)
    rows = []
    for prec, dt, gate in (("c", np.float32, GATE_SPMM_C),
                           ("z", np.float64, GATE_SPMM_Z)):
        a = _planes(ar, ai, dt)
        x = _planes(xr, xi, dt)
        ka = kernel_a(*a)
        impls = {
            "pairwalk": (spmm_pairwalk, (ka, x, starts, pa_d, px_d),
                         dict(interpret=interpret)),
            "xla": (spmm_pairs, (a, x, pa_d, px_d, py_d, ny), {}),
        }
        for name, (fn, args, kw) in impls.items():
            mem = fn.lower(*args, **kw).compile().memory_analysis()
            y = jax.block_until_ready(fn(*args, **kw))
            dev = float(np.abs(np.asarray(y[0]) + 1j * np.asarray(y[1])
                               - ref).max()) / scale
            sec = time_median(lambda: fn(*args, **kw), repeats=repeats)
            row = dict(phase="P1", prec=prec, impl=name, maxdev=dev,
                       gate=gate, ms_per_multiply=sec * 1e3,
                       tflops=flops / sec / 1e12)
            log(f"# P1 {prec} {name} memory_analysis: {mem}")
            log(json.dumps(row))
            check(dev <= gate, f"P1 {prec} {name}: maxdev {dev:.3e} > "
                               f"{gate:g}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------- P2

def phase_fd(rtb: float = 12.75) -> dict:
    """The reference's FD example through the one-call ``bsrsv_z``."""
    import tfqmrgpu_tpu as tq
    from tfqmrgpu_tpu.generator import generate_fd_problem
    from tfqmrgpu_tpu.solver import choose_engine

    t0 = time.perf_counter()
    prob = generate_fd_problem(rtb=rtb, reference=True)
    a, b = prob.a_with_data(), prob.b_with_data()
    log(f"# P2 FD rtb={rtb}: {a.nrows} block rows, {a.nnzb} A blocks, "
        f"{prob.x.nnzb} X blocks, LM=LN={prob.params['bs']}, generated in "
        f"{time.perf_counter() - t0:.2f} s")
    bs = prob.params["bs"]
    engine = choose_engine(tq.create_plan(a, prob.x, b), bs, bs, "z")
    t0 = time.perf_counter()
    xsol, info = tq.bsrsv_z(a, prob.x, b, tolerance=prob.tolerance,
                            max_iterations=2000)
    wall = time.perf_counter() - t0
    ref = prob.x_reference.astype(np.float64)
    maxdev = float(np.abs(xsol.data - ref).max() / np.abs(ref).max())
    row = dict(phase="P2", engine=engine, status=info.return_status,
               iterations=info.iterations_needed,
               residuum=info.residuum_reached, tolerance=prob.tolerance,
               maxdev=maxdev, gate=GATE_FD_MAXDEV, wall_s=wall)
    log(json.dumps(row))
    check(info.return_status == 0,
          f"P2: status {info.return_status} after "
          f"{info.iterations_needed} iterations")
    check(maxdev < GATE_FD_MAXDEV, f"P2: maxdev {maxdev:.3e}")
    return row


# ---------------------------------------------------------------- P3

def phase_golden_solve(mb: int = 281, ncols: int = 16, deg: int = 11,
                       lm: int = 32, ln: int = 32, *,
                       engines=("auto", "xla"),
                       interpret: bool = False) -> list:
    """Full solves on the golden-width banded operator, each checked by
    the NumPy pair-walk residual."""
    import tfqmrgpu_tpu as tq
    from tfqmrgpu_tpu.workloads import banded_problem, relative_residual

    rows = []
    for prec, tol, gate, cdt in (("z", 1e-10, GATE_RES_Z, np.complex128),
                                 ("c", 1e-5, GATE_RES_C, np.complex64)):
        a, x, b = banded_problem(mb, ncols, lm, ln, deg, dtype=cdt)
        for eng in engines:
            s = tq.Solver(a, x, b, precision=prec, engine=eng,
                          interpret=interpret)
            t0 = time.perf_counter()
            s.solve(tolerance=tol, max_iterations=500)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            info = s.solve(tolerance=tol, max_iterations=500)
            wall = time.perf_counter() - t0
            res = relative_residual(s.plan, a.data, s.get_matrix("X"),
                                    b.data)
            row = dict(phase="P3", prec=prec, requested=eng,
                       engine=s.engine, status=info.return_status,
                       iterations=info.iterations_needed, residual=res,
                       gate=gate, first_call_s=first, wall_s=wall)
            log(json.dumps(row))
            check(info.return_status == 0,
                  f"P3 {prec} {eng}: status {info.return_status}")
            check(res < gate, f"P3 {prec} {eng}: residual {res:.3e}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------- P4

KERNEL_SHAPES = ((16, 16), (16, 32), (16, 64), (32, 32), (32, 64), (64, 64))
# float32 sums of deg*LM products in another order than NumPy's; float64
# as in P1
KERNEL_GATES = {np.float32: 1e-5, np.float64: GATE_SPMM_Z}


def check_kernel_shapes(*, interpret: bool = False, shapes=KERNEL_SHAPES,
                        mb: int = 7, ncols: int = 2, deg: int = 3) -> None:
    """The pair-walk kernel against the NumPy pair walk at every block
    shape it takes, with an empty Y block and ragged pair counts."""
    import jax.numpy as jnp

    from tfqmrgpu_tpu.ops.pairwalk import (kernel_a, spmm_pairwalk,
                                           starts_from_pair_y)
    from tfqmrgpu_tpu.workloads import (pair_walk_reference,
                                        synthesized_golden_pairs)

    rng = np.random.default_rng(11)
    pa, px, py, ny, na, nx = synthesized_golden_pairs(mb, ncols, deg)
    keep = (py != 1) & ~((py == 2) & (pa % deg == 0))   # Y block 1 empty
    pa, px, py = pa[keep], px[keep], py[keep]
    starts = jnp.asarray(starts_from_pair_y(py, ny))
    for lm, ln in shapes:
        ac = rng.standard_normal((na, lm, lm)) \
            + 1j * rng.standard_normal((na, lm, lm))
        xc = rng.standard_normal((nx, lm, ln)) \
            + 1j * rng.standard_normal((nx, lm, ln))
        ref = pair_walk_reference(ac, xc, pa, px, py, ny)
        for dt, gate in KERNEL_GATES.items():
            y = spmm_pairwalk(kernel_a(*_planes(ac.real, ac.imag, dt)),
                              _planes(xc.real, xc.imag, dt), starts,
                              jnp.asarray(pa.astype(np.int32)),
                              jnp.asarray(px.astype(np.int32)),
                              interpret=interpret)
            got = np.asarray(y[0]) + 1j * np.asarray(y[1])
            dev = float(np.abs(got - ref).max() / np.abs(ref).max())
            check(dev <= gate, f"kernel ({lm},{ln}) {np.dtype(dt).name}: "
                               f"maxdev {dev:.3e} > {gate:g}")


def check_auto_routing() -> dict:
    """``engine='auto'`` on a sparse operator: the pair-walk kernel on a
    GPU where it takes the block shape, else the XLA block-list engine --
    never an interpreted kernel."""
    import jax

    import tfqmrgpu_tpu as tq
    from tfqmrgpu_tpu.workloads import banded_problem

    on_gpu = jax.default_backend() == "gpu"
    got = {}
    for lm in (8, 32):
        # 400 block rows: the dense A planes exceed the 'dense' limit
        a, x, b = banded_problem(mb=400, ncols=1, lm=lm, ln=lm, deg=3,
                                 dtype=np.complex64)
        s = tq.Solver(a, x, b, precision="c")
        want = "pairs" if (on_gpu and lm >= 16) else "xla"
        check(s.engine == want, f"auto at LM={lm}: {s.engine} != {want}")
        check(not s.interpret, "auto picked an interpreted kernel")
        got[lm] = s.engine
    return got


def run_gpu_checks(*, interpret: bool = False) -> None:
    """P4: the checks the test suite marks ``gpu``."""
    check_kernel_shapes(interpret=interpret)
    routes = check_auto_routing()
    log(f"# P4 kernel shapes {KERNEL_SHAPES} x (f32, f64) ok; auto routes "
        f"{routes}")


# ---------------------------------------------------------------- --four

def phase_four(mb: int = 281, ncols: int = 16, deg: int = 11, lm: int = 32,
               ln: int = 32, *, meshes=((4, 1), (2, 2)),
               interpret: bool = False) -> list:
    """The golden-width 'c' problem through ``solve_sharded`` and
    ``ShardedPanelSolver`` on each mesh, against one device."""
    import tfqmrgpu_tpu as tq
    from tfqmrgpu_tpu.parallel import ShardedPanelSolver, make_mesh, \
        solve_sharded
    from tfqmrgpu_tpu.workloads import banded_problem

    tol, maxit = 1e-5, 500
    a, x, b = banded_problem(mb, ncols, lm, ln, deg, dtype=np.complex64)
    s0 = tq.Solver(a, x, b, precision="c", interpret=interpret)
    t0 = time.perf_counter()
    i0 = s0.solve(tolerance=tol, max_iterations=maxit)
    x0 = s0.get_matrix("X")
    log(json.dumps(dict(phase="four", path="one-device", engine=s0.engine,
                        iterations=i0.iterations_needed,
                        status=i0.return_status,
                        wall_s=time.perf_counter() - t0)))
    check(i0.return_status == 0, "four: one-device solve did not converge")
    scale = float(np.abs(x0).max())
    rows = []
    for pr, pc in meshes:
        mesh = make_mesh(pr, pc)
        mesh_ids = sorted(d.id for d in mesh.devices.flat)
        runs = {"solve_sharded": lambda: solve_sharded(
            a, x, b, mesh=mesh, tolerance=tol, max_iterations=maxit)}
        panel = ShardedPanelSolver(s0.plan, mesh, precision="c")
        runs["ShardedPanelSolver"] = lambda: panel.solve(
            a.data.real, a.data.imag, b.data.real, b.data.imag,
            tolerance=tol, max_iterations=maxit)
        for path, run in runs.items():
            t0 = time.perf_counter()
            got, info = run()
            wall = time.perf_counter() - t0
            diff = float(np.abs(got - x0).max()) / scale
            row = dict(phase="four", path=path, mesh=[pr, pc],
                       engine=info.get("engine", "panel"),
                       iterations=info["iterations"],
                       status=info["return_status"], maxdiff=diff,
                       shard_devices=info["shard_devices"], wall_s=wall)
            log(json.dumps(row))
            tag = f"four {path} {pr}x{pc}"
            check(info["return_status"] == 0, f"{tag}: not converged")
            check(diff < GATE_PARITY, f"{tag}: maxdiff {diff:.3e}")
            check(abs(info["iterations"] - i0.iterations_needed)
                  <= PARITY_ITERS, f"{tag}: {info['iterations']} vs "
                                   f"{i0.iterations_needed} iterations")
            check(info["shard_devices"] == mesh_ids,
                  f"{tag}: shards on devices {info['shard_devices']}, "
                  f"mesh {mesh_ids}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    try:
        import jax

        jax.config.update("jax_enable_x64", True)
        dev = phase_device(expect_count=4 if args.four else 1)
        if args.four:
            phase_four()
        else:
            phase_multiply()
            phase_fd()
            phase_golden_solve()
            run_gpu_checks()
    except Exception as e:          # every failure ends the run non-zero
        log(f"# FAILED: {type(e).__name__}: {e}")
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
