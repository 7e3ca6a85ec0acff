"""Multi-device example: solve A @ X == B over a JAX device mesh.

The reference library is single-GPU (tfqmrgpu_handle.hxx:4-6); the mesh
layer is new territory (SURVEY.md section 5.8).  This example
shards block rows of A, X, B over all local devices with
``solve_sharded`` and then refines the float32 mesh solve to f64
residuals with ``precision='m'``.

Run on a simulated 8-device CPU mesh:
  PYTHONPATH=. JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/tfqmrgpu_sharded_example.py
On several GPUs, run it unchanged (devices are auto-detected).
"""

import numpy as np

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu.parallel import solve_sharded

mb, lm, ln, ncols = 12, 8, 8, 2
rng = np.random.default_rng(3)

# block-tridiagonal, diagonally dominant A
rows, cols = [0], []
for i in range(mb):
    cs = sorted({max(i - 1, 0), i, min(i + 1, mb - 1)})
    cols.extend(cs)
    rows.append(len(cols))
a_blocks = (rng.standard_normal((len(cols), lm, lm))
            + 1j * rng.standard_normal((len(cols), lm, lm))) * 0.2
for r in range(mb):
    for k in range(rows[r], rows[r + 1]):
        if cols[k] == r:
            a_blocks[k] += 6 * np.eye(lm)
a = tq.Bsr(mb, mb, np.asarray(rows), np.asarray(cols),
           a_blocks.astype(np.complex128), name="A")

# X pattern dense over ncols block columns; B = one block row per column
x = tq.Bsr(mb, ncols, np.arange(mb + 1) * ncols,
           np.tile(np.arange(ncols), mb),
           np.zeros((mb * ncols, lm, ln), np.complex128), name="X")
# B lives in block row 0 only (ncols blocks)
bptr = np.full(mb + 1, ncols, np.int64)
bptr[0] = 0
b_data = (rng.standard_normal((ncols, lm, ln))
          + 1j * rng.standard_normal((ncols, lm, ln)))
b = tq.Bsr(mb, ncols, bptr, np.arange(ncols),
           b_data.astype(np.complex128), name="B")

# float32 mesh solve (auto-picks the panel or block-list engine)
xc, info = solve_sharded(a, x, b, tolerance=1e-5, max_iterations=300)
print(f"sharded c: engine={info['engine']} iters={info['iterations']} "
      f"residuum={info['residuum']:.2e}")

# f64-residual mixed solve on the same mesh
xm, info_m = solve_sharded(a, x, b, precision="m", tolerance=1e-10,
                           max_iterations=600)
print(f"sharded m: {info_m['c_iterations']} c-iters + "
      f"{info_m['refine_rounds']} refine rounds -> "
      f"residuum {info_m['residuum']:.2e}")

# independent dense check
ad = np.zeros((mb * lm, mb * lm), complex)
for r in range(mb):
    for k in range(rows[r], rows[r + 1]):
        ad[r * lm:(r + 1) * lm, cols[k] * lm:(cols[k] + 1) * lm] = \
            a_blocks[k]
bd = np.zeros((mb * lm, ncols * ln), complex)
bd[0:lm * 1, :] = np.hstack([b_data[c] for c in range(ncols)])
xd = np.vstack([np.hstack([np.asarray(xm)[r * ncols + c]
                           for c in range(ncols)]) for r in range(mb)])
rel = np.linalg.norm(ad @ xd - bd) / np.linalg.norm(bd)
assert rel < 1e-9, rel
print(f"tfqmrgpu_sharded_example: OK (dense residual {rel:.2e})")
