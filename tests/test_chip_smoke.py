"""The GPU smoke check's phases at a tiny size on the CPU, the kernel
interpreted (``python chip_smoke.py`` itself refuses the CPU)."""

import jax
import pytest

import chip_smoke as cs

TINY = dict(mb=12, ncols=2, deg=3, lm=16, ln=16)


def test_phase_multiply_tiny():
    rows = cs.phase_multiply(**TINY, interpret=True, repeats=1)
    assert {(r["prec"], r["impl"]) for r in rows} == {
        ("c", "pairwalk"), ("c", "xla"), ("z", "pairwalk"), ("z", "xla")}
    assert all(r["maxdev"] <= r["gate"] for r in rows)


def test_phase_fd_small_radius():
    row = cs.phase_fd(rtb=3.75)
    assert row["status"] == 0 and row["maxdev"] < cs.GATE_FD_MAXDEV


def test_phase_golden_solve_tiny():
    rows = cs.phase_golden_solve(**TINY, engines=("pairs", "xla"),
                                 interpret=True)
    assert [(r["prec"], r["engine"]) for r in rows] == [
        ("z", "pairs"), ("z", "xla"), ("c", "pairs"), ("c", "xla")]


def test_run_gpu_checks_interpreted():
    cs.run_gpu_checks(interpret=True)


def test_phase_four_tiny():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (the CPU mesh of conftest.py)")
    # 400 block rows of LM=8: too big for 'dense', so solve_sharded takes
    # the block-list engine while ShardedPanelSolver runs the dense panels
    rows = cs.phase_four(mb=400, ncols=2, deg=3, lm=8, ln=8)
    assert {r["engine"] for r in rows} == {"blocklist", "panel"}
    assert len(rows) == 4
