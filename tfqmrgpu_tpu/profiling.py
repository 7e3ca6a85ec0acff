"""Observability: trace ranges, flop accounting, roofline audit.

The reference instruments phases with NVTX PUSH_RANGE/POP_RANGE markers
gated by -DUSE_NVTX (reference: tfqmrgpu.hxx:8-27, used at
tfqmrgpu_core.hxx:29,177,332) and accumulates analytic flop counts exposed
via getInfo (tfqmrgpu_core.hxx:133-138).  Equivalents here:

* ``trace(name)``     -- jax.profiler trace annotation (shows up in the
  profiler timeline), enabled when TFQ_TRACE=1 (the USE_NVTX analogue);
* ``start_trace/stop_trace`` -- dump a full device profile to a directory;
* ``roofline(...)``   -- analytic flops/bytes of one tfQMR iteration per
  engine, and the speed-of-light fraction of a measured iteration time
  against the device's published peaks (``DEVICE_PEAKS``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

# Published peaks per device, keyed by jax's ``device_kind``.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates without
# sparsity, at the full 700 W power limit.  A card set to a lower power
# limit cannot hold its top clock under load; report its limit beside any
# fraction computed from these numbers.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        fp64_tensor_tflops=67.0, fp32_tflops=67.0, tf32_tflops=495.0,
        hbm_gbps=3350.0),
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of a device kind; an unknown device is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add them to DEVICE_PEAKS with "
                       "their source") from None


def device_record() -> dict:
    """The device as JAX reports it: platform, device_kind, count."""
    import jax

    dev = jax.devices()[0]
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()))


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` in a child process
    (which stays off JAX); '' where nvidia-smi is absent or fails."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return ""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip() if out.returncode == 0 else ""


def time_median(fn, repeats: int = 7, warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` over ``repeats`` runs, each ending
    in ``block_until_ready`` on its result, after ``warmup`` runs."""
    import jax
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _enabled() -> bool:
    return os.environ.get("TFQ_TRACE", "0") != "0"


@contextlib.contextmanager
def trace(name: str):
    """Trace-annotation range (NVTX PUSH/POP equivalent).  Cheap no-op when
    TFQ_TRACE is unset."""
    if not _enabled():
        yield
        return
    import jax.profiler

    with jax.profiler.TraceAnnotation(name):
        yield


def start_trace(log_dir: str):
    import jax.profiler

    jax.profiler.start_trace(log_dir)


def stop_trace():
    import jax.profiler

    jax.profiler.stop_trace()


# ------------------------------------------------------------- roofline

@dataclasses.dataclass
class Roofline:
    """Analytic cost model of one tfQMR iteration + measured efficiency."""

    flops_per_iteration: float      # nominal (reference accounting)
    bytes_per_iteration: float      # compulsory device-memory traffic
    device_kind: str
    peak_tflops: float              # precision's compute ceiling
    peak_gbps: float
    compute_bound: bool
    light_speed_s: float            # max(flop/peak, bytes/bw) per iteration
    measured_s: Optional[float] = None
    fraction_of_light: Optional[float] = None
    nnz_mac_per_s: Optional[float] = None

    def __str__(self):
        s = (f"roofline[{self.device_kind}]: "
             f"{self.flops_per_iteration:.3e} flop + "
             f"{self.bytes_per_iteration:.3e} B/iter, "
             f"light-speed {self.light_speed_s*1e6:.1f} us "
             f"({'compute' if self.compute_bound else 'bandwidth'}-bound)")
        if self.fraction_of_light is not None:
            s += (f"; measured {self.measured_s*1e6:.1f} us = "
                  f"{100*self.fraction_of_light:.1f}% of light")
        return s


# passes over the X-shaped state per iteration in a perfectly fused loop:
# each of the 7 persistent complex vectors (v1, v4..v9,
# tfqmrgpu_core.hxx:49-56) read and written once, plus one read of the
# shadow vector v3
VECTOR_PASSES = 15


def solver_roofline(solver, measured_iteration_s: Optional[float] = None,
                    device_kind: Optional[str] = None) -> Roofline:
    """Audit a Solver's per-iteration cost against the device's published
    peaks (``device_kind`` defaults to the first JAX device's)."""
    import jax

    plan = solver.plan
    lm, ln = solver.lm, solver.ln
    rsize = 8 if solver.precision == "z" else 4

    from .core import flops_per_iteration

    flops = flops_per_iteration(plan.n_pairs, plan.nnzb_x, lm, ln)
    nvec = plan.nnzb_x * 2 * lm * ln * rsize
    if solver.engine == "dense":
        nr = plan.nrows * lm
        a_bytes = 2 * nr * nr * rsize
    else:
        a_bytes = plan.nnzb_a * 2 * lm * lm * rsize
    bytes_ = 2 * a_bytes + VECTOR_PASSES * nvec

    kind = device_kind or jax.devices()[0].device_kind
    peaks = device_peaks(kind)
    peak_tflops = (peaks["fp64_tensor_tflops"] if solver.precision == "z"
                   else peaks["fp32_tflops"])
    hbm_gbps = peaks["hbm_gbps"]
    t_compute = flops / (peak_tflops * 1e12)
    t_bw = bytes_ / (hbm_gbps * 1e9)
    light = max(t_compute, t_bw)
    r = Roofline(
        flops_per_iteration=flops, bytes_per_iteration=bytes_,
        device_kind=kind, peak_tflops=peak_tflops, peak_gbps=hbm_gbps,
        compute_bound=t_compute >= t_bw, light_speed_s=light,
    )
    if measured_iteration_s is not None:
        r.measured_s = measured_iteration_s
        r.fraction_of_light = light / max(measured_iteration_s, 1e-30)
        r.nnz_mac_per_s = (plan.n_pairs * lm * lm * ln
                           / measured_iteration_s / 2)
    return r


def timed_solve(solver, tolerance: float = 1e-6, max_iterations: int = 999,
                repeats: int = 2, device_kind: Optional[str] = None):
    """Run repeated solves, return (info, best_wall_s, Roofline) -- the
    nnz/s + fraction-of-light report the benchmark configs require.  The
    solve reads its result back to the host, so each wall time covers the
    device work."""
    info = solver.solve(tolerance=tolerance, max_iterations=max_iterations)
    best = None
    for _ in range(max(0, repeats - 1)):
        t0 = time.perf_counter()
        info = solver.solve(tolerance=tolerance,
                            max_iterations=max_iterations)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    if best is None:
        best = float("nan")
    iters = max(info.iterations_needed, 1)
    return info, best, solver_roofline(solver, best / iters,
                                       device_kind=device_kind)
