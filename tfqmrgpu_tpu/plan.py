"""The one-time analysis step ("createPlan").

Turns the three BSR sparsity patterns (A, X, B) into flat index tables that
every solver iteration reuses:

* ``pairs``/``starts``  -- the multiplication pair list for Y = A @ X:
  for each nonzero block ``iY`` of Y (same pattern as X), the list of
  (iA, iX) block-index pairs to multiply-accumulate
  (reference: tfqmrgpu.cu:183-230).
* ``subset``            -- for each nonzero block of B, the index of the X
  block at the same (row, col); validates B ⊆ X (tfqmrgpu.cu:233-251).
* ``colindx``           -- compressed uint16 block-column index per X block,
  with empty columns filtered out and a hard error when a column of B is
  entirely zero (tfqmrgpu.cu:254-339).

Everything here is vectorized NumPy on the host; the products are uploaded
once and stay on device (the analogue of the reference's plan object,
tfqmrgpu_plan.hxx).  The pair construction preserves the reference's exact
ordering: Y blocks in storage order, and within each Y block the A blocks of
its row in storage order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bsr import Bsr
from .errors import Status, TfqmrgpuError, encode_status

COLINDX_DTYPE = np.uint16  # reference: colIndex_t = uint16_t (tfqmrgpu.hxx:59)
MAX_BLOCK_COLUMNS = np.iinfo(COLINDX_DTYPE).max + 1  # 65,536


def _row_sorted_view(rowptr: np.ndarray, colind: np.ndarray):
    """Return (sorted_keys, perm) such that within every row the column
    indices are ascending; ``perm`` maps sorted slots back to original nnz
    indices.  Works whether or not the input is already row-sorted."""
    nrows = rowptr.shape[0] - 1
    row_of = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(rowptr))
    # composite key: strictly increasing across rows, ascending within a row
    span = np.int64(colind.max(initial=0)) - np.int64(colind.min(initial=0)) + 1
    base = np.int64(colind.min(initial=0))
    keys = row_of * span + (colind.astype(np.int64) - base)
    perm = np.argsort(keys, kind="stable")
    return keys[perm], perm, span, base, row_of


def _lookup(rowptr, sorted_keys, perm, span, base, q_rows, q_cols):
    """Vectorized membership query: for each (row, col) return the original
    nnz index in the pattern, or -1 if absent.  The reference does this with
    a linear ``find_in_array`` (bsr.hxx:27-39); here it is one searchsorted
    over a composite row-major key."""
    if sorted_keys.shape[0] == 0:
        return np.full(q_rows.shape, -1, dtype=np.int64)
    q_off = q_cols.astype(np.int64) - base
    in_range = (q_off >= 0) & (q_off < span)
    q_keys = q_rows.astype(np.int64) * span + np.where(in_range, q_off, 0)
    pos = np.minimum(np.searchsorted(sorted_keys, q_keys), sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == q_keys) & in_range
    return np.where(hit, perm[pos], -1)


@dataclasses.dataclass
class Plan:
    """Analysis products + solve statistics (reference: tfqmrgpu_plan.hxx)."""

    nrows: int                    # number of block rows (== block cols of A)
    ncols: int                    # number of NON-EMPTY block columns of X
    nnzb_a: int
    nnzb_x: int
    nnzb_b: int
    starts: np.ndarray            # uint32[nnzbX+1]
    pairs: np.ndarray             # uint32[nPairs, 2] -- (iA, iX)
    subset: np.ndarray            # uint32[nnzbB] -- X index where B is nonzero
    colindx: np.ndarray           # uint16[nnzbX] -- compressed column index
    original_colind_x: np.ndarray  # int32[nCols] -- original column id per compressed col
    rowptr_x: np.ndarray          # int32[nrows+1] (kept for partitioning/IO)
    colind_x: np.ndarray          # int32[nnzbX]
    rowptr_b: np.ndarray
    colind_b: np.ndarray
    rowptr_a: np.ndarray
    colind_a: np.ndarray
    # block shape & precision get attached at bufferSize/setup time
    lm: int = 0
    ln: int = 0
    precision: str = "?"
    # statistics of the last solve (reference: tfqmrgpu_plan.hxx:41-44)
    residuum_reached: float = -1.0
    iterations_needed: int = -1
    flops_performed: float = -1.0
    flops_performed_all: float = 0.0

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])

    # ------------------------------------------------------ serialization

    _ARRAY_FIELDS = ("starts", "pairs", "subset", "colindx",
                     "original_colind_x", "rowptr_x", "colind_x",
                     "rowptr_b", "colind_b", "rowptr_a", "colind_a")
    _SCALAR_FIELDS = ("nrows", "ncols", "nnzb_a", "nnzb_x", "nnzb_b",
                      "lm", "ln")

    def save(self, path: str):
        """Persist the analysis products (.npz).  A saved plan skips the
        createPlan step entirely on reload -- the offline-analysis analogue
        of the reference's reusable plan object (tfqmrgpu_plan.hxx)."""
        payload = {k: getattr(self, k) for k in self._ARRAY_FIELDS}
        payload["scalars"] = np.array(
            [getattr(self, k) for k in self._SCALAR_FIELDS], dtype=np.int64)
        payload["precision"] = np.array(self.precision)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "Plan":
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in cls._ARRAY_FIELDS}
            scalars = dict(zip(cls._SCALAR_FIELDS, z["scalars"].tolist()))
            precision = str(z["precision"])
        return cls(**arrays, **scalars, precision=precision)

    def memory_requirement_bytes(self, lm: int, ln: int, precision: str = "z") -> int:
        """Device-memory estimate of one solve, the analogue of
        tfqmrgpu_bsrsv_bufferSize's memcount-mode (tfqmrgpu_core.hxx:49-99).
        XLA allocates for real, so this is informational."""
        rsize = 8 if precision == "z" else 4
        nX, nB, nC = self.nnzb_x, self.nnzb_b, self.ncols
        vec = 2 * lm * ln * rsize
        total = 7 * nX * vec                      # v1, v4..v9
        total += nX * 2 * lm * ln * 4             # v3 shadow (always float32)
        total += nB * vec                         # v2 = B
        total += 5 * nC * 2 * ln * rsize          # rho, alfa, beta, c67, eta
        total += nC * 2 * ln * 8 + nC * ln * 8    # zvv/dvv result slots
        total += 2 * nC * ln * 8                  # tau, var
        total += nX * 2 + nB * 4 + nC * ln        # colindx, subset, status
        total += self.starts.nbytes + self.pairs.nbytes
        total += self.nnzb_a * 2 * lm * lm * rsize
        return int(total)


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 16


def create_plan(
    a: Bsr,
    x: Bsr,
    b: Bsr,
    index_offset: int = 0,
    echo: int = 0,
    cache: bool = True,
) -> Plan:
    """Build the multiplication/subset/column-compression tables.

    Mirrors tfqmrgpu_bsrsv_createPlan (tfqmrgpu.cu:136-351) including its
    validation rules and error codes; runs vectorized instead of the
    reference's nested host loops.  Results are memoized on the three
    sparsity-pattern hashes (the reference reuses a plan across solves;
    here the reuse is automatic) -- each hit returns a fresh shallow copy
    so per-solver statistics do not alias.
    """
    if cache:
        key = (a.pattern_key(), x.pattern_key(), b.pattern_key(),
               int(index_offset))
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            if echo > 5:
                print("# create_plan: pattern-cache hit")
            return dataclasses.replace(
                hit, residuum_reached=-1.0, iterations_needed=-1,
                flops_performed=-1.0, flops_performed_all=0.0)
        plan = create_plan(a, x, b, index_offset, echo, cache=False)
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = plan
        return dataclasses.replace(plan)
    mb = a.nrows
    # --- static plausibility checks (tfqmrgpu.cu:166-172)
    if mb < 1:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 1), "mb < 1")
    if x.nnzb < 1:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 2), "nnzbX < 1")
    if b.nnzb > x.nnzb:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 3),
                            "nnzbB > nnzbX: B cannot be a subset of X")
    if a.nnzb > mb * mb:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 4),
                            "nnzbA > mb^2: A must be logically square")
    for op in (a, x, b):
        op.validate()
    if x.nrows != mb or b.nrows != mb:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 5),
                            "A, X, B must have the same number of block rows")

    c0f1 = int(index_offset)
    rowptr_a = a.rowptr.astype(np.int64) - c0f1
    rowptr_x = x.rowptr.astype(np.int64) - c0f1
    rowptr_b = b.rowptr.astype(np.int64) - c0f1
    colind_a = a.colind.astype(np.int64) - c0f1
    colind_x = x.colind.astype(np.int64) - c0f1
    colind_b = b.colind.astype(np.int64) - c0f1

    nnzb_x = x.nnzb

    # sorted composite-key view of X's pattern for membership queries
    skeys, perm, span, base, _ = _row_sorted_view(rowptr_x, colind_x)

    # --- multiplication pair list (tfqmrgpu.cu:183-230) -------------------
    # Y has X's pattern.  For Y block iY at (irow, jcol):
    #   for each A block inza in row irow with column k:
    #     if X has a block at (k, jcol): emit pair (inza, inzx).
    n_a_per_row = np.diff(rowptr_a)
    row_of_y = np.repeat(np.arange(mb, dtype=np.int64), np.diff(rowptr_x))
    combo = n_a_per_row[row_of_y]                     # A candidates per Y block
    m_total = int(combo.sum())
    iy_idx = np.repeat(np.arange(nnzb_x, dtype=np.int64), combo)
    group_start = np.cumsum(combo) - combo
    off = np.arange(m_total, dtype=np.int64) - np.repeat(group_start, combo)
    ia_idx = rowptr_a[row_of_y[iy_idx]] + off         # candidate A nnz index
    k_mid = colind_a[ia_idx]                          # middle block row/col
    jcol = colind_x[iy_idx]
    inzx = _lookup(rowptr_x, skeys, perm, span, base, k_mid, jcol)
    valid = inzx >= 0
    pairs = np.stack([ia_idx[valid], inzx[valid]], axis=1).astype(np.uint32)
    counts = np.bincount(iy_idx[valid], minlength=nnzb_x)
    starts = np.zeros(nnzb_x + 1, dtype=np.uint32)
    np.cumsum(counts, out=starts[1:])
    if echo > 6:
        print(f"# create_plan: found {pairs.shape[0]} pairs in A*X multiplication")

    # --- subset list, B ⊆ X check (tfqmrgpu.cu:233-251) -------------------
    row_of_b = np.repeat(np.arange(mb, dtype=np.int64), np.diff(rowptr_b))
    inzx_of_b = _lookup(rowptr_x, skeys, perm, span, base, row_of_b, colind_b)
    missing = inzx_of_b < 0
    if np.any(missing):
        irow_bad = int(row_of_b[np.argmax(missing)])
        raise TfqmrgpuError(
            encode_status(Status.B_IS_NOT_SUBSET_OF_X, irow_bad),
            f"in row {irow_bad + c0f1} B has a block where X does not",
        )
    subset = inzx_of_b.astype(np.uint32)

    # --- column compression -> colindx (tfqmrgpu.cu:254-339) --------------
    # NOTE: the reference works on the RAW column indices here (no index
    # offset subtraction), relying only on their range.
    raw_cols_x = x.colind.astype(np.int64)
    min_col = int(raw_cols_x.min())
    max_col = int(raw_cols_x.max())
    nc = max_col - min_col + 1
    occupancy = np.bincount(raw_cols_x - min_col, minlength=nc)
    occupied = occupancy > 0
    nb = int(occupied.sum())
    if nb < 1:
        raise TfqmrgpuError(encode_status(Status.UNDOCUMENTED_ERROR, 6),
                            "X has no nonzero columns")
    if nb > MAX_BLOCK_COLUMNS:
        raise TfqmrgpuError(
            encode_status(Status.UNDOCUMENTED_ERROR, 7),
            f"{nb} block columns exceed the colindx limit of {MAX_BLOCK_COLUMNS}",
        )
    nempty = nc - nb
    if nempty > 0 and echo > 0:
        print(f"# create_plan: found {nempty} empty columns in X!")
    translate = np.full(nc, -1, dtype=np.int64)
    translate[occupied] = np.arange(nb)
    colindx = translate[raw_cols_x - min_col].astype(COLINDX_DTYPE)
    original_colind_x = (np.flatnonzero(occupied) + min_col).astype(np.int32)

    # sanity: at least one nonzero block of B per nonzero column of X
    # (tfqmrgpu.cu:316-337)
    cols_of_b = translate[raw_cols_x[subset] - min_col]
    b_col_occupancy = np.bincount(cols_of_b, minlength=nb)
    n_zero_cols_b = int((b_col_occupancy < 1).sum())
    if n_zero_cols_b > 0:
        raise TfqmrgpuError(
            encode_status(Status.B_HAS_A_ZERO_COLUMN, n_zero_cols_b),
            f"{n_zero_cols_b} columns of B are entirely zero "
            "(guaranteed breakdown)",
        )

    return Plan(
        nrows=mb,
        ncols=nb,
        nnzb_a=a.nnzb,
        nnzb_x=x.nnzb,
        nnzb_b=b.nnzb,
        starts=starts,
        pairs=pairs,
        subset=subset,
        colindx=colindx,
        original_colind_x=original_colind_x,
        rowptr_x=(rowptr_x).astype(np.int32),
        colind_x=(colind_x).astype(np.int32),
        rowptr_b=(rowptr_b).astype(np.int32),
        colind_b=(colind_b).astype(np.int32),
        rowptr_a=(rowptr_a).astype(np.int32),
        colind_a=(colind_a).astype(np.int32),
    )
