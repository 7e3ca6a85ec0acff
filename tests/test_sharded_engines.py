"""Both sharded engines on the CPU mesh: parity with the one-device solve
on a rows-only and a 2-D mesh, and every device holds a shard."""

import jax
import numpy as np
import pytest

from tfqmrgpu_tpu import Solver, create_plan
from tfqmrgpu_tpu.parallel import (ShardedBlockListSolver, ShardedPanelSolver,
                                   make_mesh)

from conftest import make_random_problem

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 simulated devices")

ENGINES = {"panel": ShardedPanelSolver, "blocklist": ShardedBlockListSolver}


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_sharded_engine_parity(rng, engine, mesh_shape):
    lm = ln = 4
    a, x, b = make_random_problem(rng, mb=13, lm=lm, ln=ln, ncols=3,
                                  x_fill=0.7, dtype=np.complex64)
    tol = 1e-5
    s0 = Solver(a, x, b, precision="c", engine="xla")
    i0 = s0.solve(tolerance=tol, max_iterations=300)
    x0 = s0.get_matrix("X")

    plan = create_plan(a, x, b)
    plan.lm, plan.ln = lm, ln
    mesh = make_mesh(*mesh_shape)
    sp = ENGINES[engine](plan, mesh, precision="c")
    got, info = sp.solve(a.data.real, a.data.imag, b.data.real, b.data.imag,
                         tolerance=tol, max_iterations=300)
    assert info["return_status"] == 0
    # the parity rules of the four-card smoke phase
    assert abs(info["iterations"] - i0.iterations_needed) <= 2
    assert np.abs(got - x0).max() / np.abs(x0).max() < 1e-3
    assert info["shard_devices"] == sorted(d.id for d in mesh.devices.flat)
