"""Test configuration: a simulated 8-device CPU mesh with x64 enabled.

The environment must be set before the first jax import.  The CPU is
forced unless ``TFQ_TESTS_ON_GPU=1`` asks to run on the card (for the tests
marked ``gpu``: ``TFQ_TESTS_ON_GPU=1 python -m pytest tests -m gpu``).
Whether a card is present is decided inside the ``gpu`` fixture, never
while a module is imported.
"""

import os

if os.environ.get("TFQ_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end bench/driver tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels); skips "
                   "elsewhere")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run with TFQ_TESTS_ON_GPU=1 on "
                    "the card")


def make_random_problem(rng, mb=12, lm=4, ln=8, ncols=3, x_fill=0.6,
                        b_per_col=1, dtype=np.complex128, diag_dominant=True,
                        seed_shift=0):
    """Random diagonally-dominant block problem: A square [mb x mb] blocks
    of [lm, lm]; X pattern [mb x ncols] with ~x_fill density; B subset of X
    with b_per_col blocks per column.  Returns (A, X, B) Bsr objects with
    data on A and B."""
    from tfqmrgpu_tpu.bsr import Bsr

    rng = np.random.default_rng(rng.integers(1 << 31) + seed_shift)
    # A pattern: diagonal + random off-diagonals, sorted cols per row
    rows_a, cols_a = [], []
    for i in range(mb):
        cols = {i}
        for j in rng.integers(0, mb, size=3):
            cols.add(int(j))
        cols = sorted(cols)
        rows_a.append(len(cols))
        cols_a.extend(cols)
    rowptr_a = np.concatenate([[0], np.cumsum(rows_a)])
    nnzb_a = len(cols_a)
    a_data = (rng.standard_normal((nnzb_a, lm, lm))
              + 1j * rng.standard_normal((nnzb_a, lm, lm))).astype(dtype)
    if diag_dominant:
        diag_idx = [int(rowptr_a[i] + list(
            cols_a[rowptr_a[i]:rowptr_a[i + 1]]).index(i)) for i in range(mb)]
        eye = np.eye(lm)
        for i, d in enumerate(diag_idx):
            a_data[d] += (4.0 * rows_a[i] * lm) * eye
    a = Bsr(mb, mb, rowptr_a, np.array(cols_a), a_data, name="A")

    # X pattern: every column j appears in a random subset of rows,
    # always including row j (where B will sit)
    x_cols_per_row = [[] for _ in range(mb)]
    b_rows_per_col = {}
    for j in range(ncols):
        nrows_j = max(2, int(x_fill * mb))
        rows = set(rng.choice(mb, size=nrows_j, replace=False).tolist())
        rows.add(j % mb)
        for r in rows:
            x_cols_per_row[r].append(j)
        b_rows_per_col[j] = sorted(rows)[:b_per_col]
        if (j % mb) not in b_rows_per_col[j]:
            b_rows_per_col[j][0] = j % mb
    rowptr_x, cols_x = [0], []
    for r in range(mb):
        cs = sorted(x_cols_per_row[r])
        cols_x.extend(cs)
        rowptr_x.append(len(cols_x))
    x = Bsr(mb, ncols, np.array(rowptr_x), np.array(cols_x), None, name="X")

    rowptr_b, cols_b = [0], []
    for r in range(mb):
        cs = sorted(j for j, rr in b_rows_per_col.items() if r in rr)
        cols_b.extend(cs)
        rowptr_b.append(len(cols_b))
    nnzb_b = len(cols_b)
    b_data = (rng.standard_normal((nnzb_b, lm, ln))
              + 1j * rng.standard_normal((nnzb_b, lm, ln))).astype(dtype)
    b = Bsr(mb, ncols, np.array(rowptr_b), np.array(cols_b), b_data, name="B")
    return a, x, b


def dense_from_bsr(bsr, lm, d2):
    """Assemble the dense matrix of a Bsr with data."""
    m = np.zeros((bsr.nrows * lm, bsr.ncols * d2), dtype=complex)
    row = bsr.row_of()
    for inz in range(bsr.nnzb):
        r, c = int(row[inz]), int(bsr.colind[inz])
        m[r * lm:(r + 1) * lm, c * d2:(c + 1) * d2] = bsr.data[inz]
    return m
