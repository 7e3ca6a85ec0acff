"""Multi-HOST parity: a simulated 2-process x 4-device CPU cluster
(jax.distributed + gloo) must reproduce the single-process 8-device
sharded solve bit-for-bit in iterations and closely in the iterate
(SURVEY.md section 7's multi-host validation strategy; the reference has
no distributed layer at all)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_multihost_parity_vs_single_process(tmp_path):
    port = _free_port()
    out = str(tmp_path / "mh_result.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)        # worker sets its own
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "multihost_worker.py"),
         str(p), "2", str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(2)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
        outs.append(o)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    got = np.load(out)

    # single-process reference on the same 8 simulated devices
    sys.path.insert(0, HERE)
    from conftest import make_random_problem

    from tfqmrgpu_tpu.plan import create_plan
    from tfqmrgpu_tpu.parallel import make_mesh
    from tfqmrgpu_tpu.parallel import ShardedBlockListSolver

    rng = np.random.default_rng(123)
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=16, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0, dtype=np.complex64)
    plan = create_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    sp = ShardedBlockListSolver(plan, make_mesh(8, 1))
    xref, info = sp.solve(a.data.real.astype(np.float32),
                          a.data.imag.astype(np.float32),
                          b.data.real.astype(np.float32),
                          b.data.imag.astype(np.float32),
                          tolerance=1e-4, max_iterations=300)
    assert int(got["iterations"]) == int(info["iterations"])
    assert int(got["status"]) == int(info["return_status"])
    scale = np.abs(xref).max()
    assert np.abs(got["x"] - xref).max() / scale < 1e-5
