"""Autotuner: isolated-multiply timing, candidate sweep, persistent cache."""

import json
import os

import numpy as np
import pytest

from tfqmrgpu_tpu import autotune
from tfqmrgpu_tpu.solver import Solver

from conftest import dense_from_bsr, make_random_problem


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TFQ_AUTOTUNE_CACHE", str(tmp_path))
    return tmp_path / "autotune.json"


def test_time_multiply_positive(rng):
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    s = Solver(a, x, b, precision="c", engine="xla")
    dt = autotune.time_multiply(s, nrep=4, repeats=2)
    assert dt > 0


def test_autotune_picks_working_solver_and_caches(rng, tune_cache):
    lm, ln = 4, 8
    a, x, b = make_random_problem(rng, mb=10, lm=lm, ln=ln, ncols=3,
                                  x_fill=1.0, dtype=np.complex64)
    cands = ["dense", "xla", "pairs"]
    # LM=4: the pairs kernel refuses the shape and lands in the table as
    # an error row
    s, table = autotune.autotune_solver(a, x, b, precision="c",
                                        candidates=cands, nrep=4, echo=0,
                                        interpret=True)
    timed = [r for r in table if "ms_per_multiply" in r]
    assert timed, table
    assert any(r["engine"] == "pairs" and "error" in r for r in table)
    # winner == fastest timed row
    best_row = min(timed, key=lambda r: r["ms_per_multiply"])
    assert s.engine == best_row["engine"]
    # the winning solver actually solves
    info = s.solve(tolerance=1e-4, max_iterations=300)
    assert info.return_status == 0
    xd = dense_from_bsr(x.with_data(s.get_matrix("X")), lm, ln)
    ad = dense_from_bsr(a, lm, lm)
    bd = dense_from_bsr(b, lm, ln)
    assert np.max(np.abs(ad @ xd - bd)) / np.max(np.abs(bd)) < 5e-3
    # cache written and keyed
    assert tune_cache.exists()
    cache = json.loads(tune_cache.read_text())
    assert len(cache) == 1
    (entry,) = cache.values()
    assert entry["engine"] == best_row["engine"]

    # second call: cache hit, no re-measurement
    s2, table2 = autotune.autotune_solver(a, x, b, precision="c",
                                          candidates=cands, nrep=4)
    assert len(table2) == 1 and table2[0].get("cached")
    assert s2.engine == s.engine
    info2 = s2.solve(tolerance=1e-4, max_iterations=300)
    assert info2.return_status == 0


def test_autotune_cache_key_differs_by_pattern(rng, tune_cache):
    a, x, b = make_random_problem(rng, mb=8, lm=4, ln=4, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    a2, x2, b2 = make_random_problem(rng, mb=12, lm=4, ln=4, ncols=2,
                                     x_fill=0.7, dtype=np.complex64,
                                     seed_shift=5)
    cands = ["xla"]
    autotune.autotune_solver(a, x, b, precision="c", candidates=cands,
                             nrep=2)
    autotune.autotune_solver(a2, x2, b2, precision="c", candidates=cands,
                             nrep=2)
    cache = json.loads(tune_cache.read_text())
    assert len(cache) == 2
