"""Reader for SpMM multiplication-plan files.

Format (reference parser: bench_tfqmrgpu.cu:456-509): a header line
``#nnzb_for_Y_A_X= <nnzY> <nnzA> <nnzX>`` followed by one line per pair
``iY iA iX beta`` where beta == 0 starts a new Y block (accumulator cleared)
and beta == 1 continues accumulation into the same Y block.  The golden
assets test/multiplication/plan_unordered.14-287-16 and plan_reordered.*
use this format.

Such a file carries no BSR structure, so ``recover_geometry`` recovers the
(row fragment, column) labels of its X/Y pattern by union-find, and
``recover_grid`` factors it into a (row slot x column) grid.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass
class PlanFile:
    nnzb_y: int
    nnzb_a: int
    nnzb_x: int
    starts: np.ndarray   # uint32[nnzbY+1]
    pairs: np.ndarray    # uint32[nPairs, 2]  (iA, iX)
    y_order: np.ndarray  # int64[nnzbY]: the iY index of each group, in file order


def read_plan_file(filename: str) -> PlanFile:
    with open(filename) as f:
        header = f.readline().split()
        nnzb_y, nnzb_a, nnzb_x = int(header[-3]), int(header[-2]), int(header[-1])
        body = np.loadtxt(f, dtype=np.int64)
    if body.ndim == 1:
        body = body[None, :]
    iy, ia, ix, beta = body[:, 0], body[:, 1], body[:, 2], body[:, 3]
    # a new group starts whenever iY changes (beta flags are consistency info)
    new_group = np.ones(iy.shape[0], dtype=bool)
    new_group[1:] = iy[1:] != iy[:-1]
    assert np.all(beta[new_group] == 0), "group heads must carry beta=0"
    assert np.all(beta[~new_group] == 1), "continuations must carry beta=1"
    group_starts = np.flatnonzero(new_group)
    starts = np.concatenate([group_starts, [iy.shape[0]]]).astype(np.uint32)
    assert starts.shape[0] == nnzb_y + 1, (
        f"{starts.shape[0] - 1} Y groups, header says {nnzb_y}")
    pairs = np.stack([ia, ix], axis=1).astype(np.uint32)
    return PlanFile(nnzb_y=nnzb_y, nnzb_a=nnzb_a, nnzb_x=nnzb_x,
                    starts=starts, pairs=pairs, y_order=iy[new_group])


# ------------------------------------------------------- geometry recovery

def _find(par: np.ndarray, i: int) -> int:
    r = i
    while par[r] != r:
        r = par[r]
    while par[i] != r:
        par[i], i = r, par[i]
    return int(r)


def recover_geometry(pair_a, pair_x, pair_y, nnzb_y: int):
    """Recover (row_fragment, column) labels of the shared X/Y pattern space
    from a bare pair list.  Returns (frag[nnzb_y], col[nnzb_y])."""
    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    n = pa.shape[0]

    def _union(par, a, b):
        ra, rb = _find(par, int(a)), _find(par, int(b))
        if ra != rb:
            par[ra] = rb

    par = np.arange(nnzb_y)
    o = np.argsort(pa, kind="stable")
    pa_s, py_s, px_s = pa[o], py[o], px[o]
    i = 0
    while i < n:
        j = i + 1
        while j < n and pa_s[j] == pa_s[i]:
            j += 1
        for t in range(i + 1, j):
            # same iA => same block row for the Y blocks AND the same middle
            # row for the X blocks (col(iA) is one row index)
            _union(par, py_s[i], py_s[t])
            _union(par, px_s[i], px_s[t])
        i = j
    frag = np.fromiter((_find(par, i) for i in range(nnzb_y)), np.int64,
                       nnzb_y)
    _, frag = np.unique(frag, return_inverse=True)

    par = np.arange(nnzb_y)
    for t in range(n):
        ra, rb = _find(par, int(py[t])), _find(par, int(px[t]))
        if ra != rb:
            par[ra] = rb
    col = np.fromiter((_find(par, i) for i in range(nnzb_y)), np.int64,
                      nnzb_y)
    _, col = np.unique(col, return_inverse=True)
    return frag, col


def _cuthill_mckee(nfrag: int, edges_a: np.ndarray, edges_b: np.ndarray):
    """BFS (Cuthill-McKee) ordering of the fragment graph -> rank[nfrag]."""
    adj = [set() for _ in range(nfrag)]
    for a, b in zip(edges_a, edges_b):
        if a != b:
            adj[a].add(int(b))
            adj[b].add(int(a))
    order = []
    seen = np.zeros(nfrag, bool)
    deg = np.array([len(s) for s in adj])
    for s in np.argsort(deg):
        if seen[s]:
            continue
        seen[s] = True
        dq = deque([int(s)])
        while dq:
            u = dq.popleft()
            order.append(u)
            for v in sorted(adj[u], key=lambda v: len(adj[v])):
                if not seen[v]:
                    seen[v] = True
                    dq.append(v)
    rank = np.zeros(nfrag, np.int64)
    rank[np.array(order)] = np.arange(nfrag)
    return rank


class PairGrid(NamedTuple):
    """A (row-slot x column) grid factorization of a bare pair list.

    Row slots are the pair list's connected row FRAGMENTS
    (``recover_geometry``), ordered by Cuthill-McKee rank so
    neighboring slots share A operands.  Fragments of one true matrix row
    that never share an A block (distant RHS clusters) stay separate
    slots, so grid density equals nnzb / (nfrag * ncol) -- callers should
    check it before choosing this engine.  (Packing column-disjoint
    fragments into shared slots was measured to violate cell injectivity
    on real FD plans: a grid cell (slot, slot') may host only ONE
    (target-fragment, operand-fragment) pair, and dense packings collide
    on essentially every fragment.)"""

    nslots: int
    ncols: int
    slot_of: np.ndarray      # int32[nnzb] row slot of each X/Y block
    col_of: np.ndarray       # int32[nnzb]
    rowptr: np.ndarray       # int64[nslots+1] slot-A CSR
    colind: np.ndarray       # int64[nnzbA] operand slots
    a_order: np.ndarray      # int64[nnzbA]: slot-A position -> original pa


def recover_grid(pair_a, pair_x, pair_y, nnzb: int) -> PairGrid:
    """Factor a bare pair list into a (slot x col) grid (see PairGrid)."""
    pa = np.asarray(pair_a, dtype=np.int64)
    px = np.asarray(pair_x, dtype=np.int64)
    py = np.asarray(pair_y, dtype=np.int64)
    frag, col = recover_geometry(pa, px, py, nnzb)
    nfrag = int(frag.max()) + 1
    ncol = int(col.max()) + 1
    rank = _cuthill_mckee(nfrag, frag[py], frag[px])

    # one slot per fragment, in CM order (operand slots stay nearby);
    # rank IS the slot id (position of each fragment in CM order)
    slot_of_frag = rank

    # A-block endpoints in fragment space (each USED pa has a unique
    # (fy, fx); ids absent from the pair list -- plan files carry them --
    # must not be materialized anywhere)
    o = np.argsort(pa, kind="stable")
    first = np.concatenate([[True], pa[o][1:] != pa[o][:-1]])
    used = pa[o][first]                   # unique pa ids, ascending
    fy = frag[py[o][first]]
    fx = frag[px[o][first]]

    slot_of = slot_of_frag[frag].astype(np.int32)
    ra = slot_of_frag[fy]
    ca = slot_of_frag[fx]
    csr_order = np.lexsort((ca, ra))
    rowptr = np.searchsorted(ra[csr_order], np.arange(nfrag + 1))
    return PairGrid(nslots=int(nfrag), ncols=int(ncol), slot_of=slot_of,
                    col_of=col.astype(np.int32),
                    rowptr=rowptr.astype(np.int64),
                    colind=ca[csr_order],
                    a_order=used[csr_order])
