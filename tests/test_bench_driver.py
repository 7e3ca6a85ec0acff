"""Repo-root bench.py: it measures the card only (no result on the CPU),
and it reads multiplication plans -- a plan file, else the synthesized
plan of the golden plan's size -- in the order its engines need."""

import importlib.util
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_module():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_sparse_plan(path, mb=30, ncols=4, deg=3, fill=0.4, seed=5):
    """A small plan file whose recovered fragment grid is SPARSE
    (density well under the 0.6 rowtile-outright threshold), so the
    bench exercises the rowtile-vs-pairpanel race path."""
    rng = np.random.default_rng(seed)
    xid = -np.ones((mb, ncols), np.int64)
    cells = [(r, c) for r in range(mb) for c in range(ncols)]
    rng.shuffle(cells)
    keep = set(cells[: int(fill * len(cells))])
    for c in range(ncols):
        if not any(cc == c for _, cc in keep):
            keep.add((int(rng.integers(mb)), c))
    cnt = 0
    for r, c in sorted(keep):
        xid[r, c] = cnt
        cnt += 1
    rowptr = [0]
    colind = []
    for r in range(mb):
        cs = sorted({(r + s) % mb for s in range(deg)})
        colind.extend(cs)
        rowptr.append(len(colind))
    lines = []
    ny = 0
    for r in range(mb):
        for c in range(ncols):
            iy = xid[r, c]
            if iy < 0:
                continue
            first = True
            for ia in range(rowptr[r], rowptr[r + 1]):
                ix = xid[colind[ia], c]
                if ix < 0:
                    continue
                lines.append(f"{iy} {ia} {ix} {0 if first else 1}")
                first = False
            if not first:
                ny += 1
    with open(path, "w") as f:
        f.write(f"#nnzb_for_Y_A_X= {ny} {len(colind)} {cnt}\n")
        f.write("\n".join(lines) + "\n")


def test_bench_refuses_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TFQ_", "JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 2
    assert not [line for line in out.stdout.splitlines()
                if line.startswith("{")]


def test_bench_synthesized_plan_is_named(monkeypatch):
    monkeypatch.delenv("TFQ_PLAN_FILE", raising=False)
    label, pa, px, py, ny, na, nx = _bench_module().load_pairs()
    assert label == "synthesized_golden_size"
    assert (len(pa), ny, na, nx) == (49456, 4496, 3091, 4496)
    assert np.all(np.diff(py) >= 0)


def test_bench_plan_file_pairs_sorted_by_y(tmp_path, monkeypatch):
    from tfqmrgpu_tpu.io.planfile import read_plan_file

    plan = tmp_path / "sparse_plan.txt"
    _write_sparse_plan(str(plan))
    monkeypatch.setenv("TFQ_PLAN_FILE", str(plan))
    label, pa, px, py, ny, na, nx = _bench_module().load_pairs()
    assert label == "plan_sparse_plan_txt"
    assert np.all(np.diff(py) >= 0)
    pf = read_plan_file(str(plan))
    assert len(pa) == pf.pairs.shape[0] and ny == pf.nnzb_y
    # the same multiset of (iY, iA, iX) triples as the file
    y_file = np.repeat(pf.y_order, np.diff(pf.starts.astype(np.int64)))
    want = sorted(zip(y_file, pf.pairs[:, 0], pf.pairs[:, 1]))
    assert sorted(zip(py, pa, px)) == want
