"""Worker for the multi-host parity test: one JAX process of a simulated
2-process x 4-device CPU cluster solving the shared fixed problem through
ShardedBlockListSolver.  Usage: multihost_worker.py <pid> <nproc> <port> <out>
(SURVEY.md section 7: multi-host parity vs 1-host via multi-process CPU
simulation)."""

import os
import sys

pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                         int(sys.argv[3]), sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np  # noqa: E402

from tfqmrgpu_tpu.parallel import multihost as mh  # noqa: E402

mh.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)

import jax  # noqa: E402

assert jax.device_count() == 4 * nproc, jax.device_count()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from conftest import make_random_problem  # noqa: E402

from tfqmrgpu_tpu.plan import create_plan  # noqa: E402
from tfqmrgpu_tpu.parallel import ShardedBlockListSolver  # noqa: E402

rng = np.random.default_rng(123)
lm = ln = 4
a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=3,
                              x_fill=1.0, dtype=np.complex64)
plan = create_plan(a, x, b)
plan.lm, plan.ln = lm, ln
mesh = mh.global_mesh(pr=jax.device_count())
sp = ShardedBlockListSolver(plan, mesh)
xsol, info = sp.solve(a.data.real.astype(np.float32),
                      a.data.imag.astype(np.float32),
                      b.data.real.astype(np.float32),
                      b.data.imag.astype(np.float32),
                      tolerance=1e-4, max_iterations=300)
if pid == 0:
    np.savez(out, x=xsol, iterations=info["iterations"],
             status=info["return_status"])
print(f"[{pid}] done iters={info['iterations']}", flush=True)
