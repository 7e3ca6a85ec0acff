"""Device-side operator library (the analogue of the reference's L0/L1).

* ``layout``      -- host/device data-layout conversion (RIRIRIRI interleave,
                     split re/im planes, block transpose/conjugation).
* ``linalg``      -- per-column fused vector ops: axpy/xpay, segmented
                     dotp/nrm2 reductions, RHS scatter-add.
* ``decisions``   -- the three tfQMR scalar decision updates (dec35/dec34/decT).
* ``blocksparse`` -- block-sparse Y = A @ X over a multiplication pair list
                     (plain-XLA gather/batched-matmul path).
* ``pairwalk``    -- the pair-walk SpMM kernel (Pallas through Triton).
* ``panel``       -- the dense row-panel vector layout and primitives.
"""

from . import layout
from . import linalg
from . import decisions
from . import blocksparse

__all__ = ["layout", "linalg", "decisions", "blocksparse", "panel",
           "pairwalk"]


def __getattr__(name):
    # lazy submodule access (pairwalk imports the Pallas machinery; keep
    # the base import light)
    if name in ("panel", "pairwalk"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
