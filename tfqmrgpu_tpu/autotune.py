"""Runtime autotuning -- the replacement for the reference's compile-time
block-size registry and hand-made TUNE table.

The reference enumerates 15 (LM, LN) template instantiations plus a
per-size TUNE constant (reference: allowed_block_sizes.h,
bench_tfqmrgpu.cu:529-547 "extracted from comparison of TUNE={1,2,3,4,6,8}").
Here block shapes are traced jit parameters, so ANY (LM, LN) compiles; what
remains tunable at runtime is the ENGINE (dense / xla / pairs).

``autotune_solver`` measures candidates on the actual problem and returns
the fastest Solver.  Two departures from the naive approach:

* the measured quantity is the ISOLATED multiply (a fori_loop chain of
  ``nrep`` multiplies, timed to ``block_until_ready``), not a full solve --
  full solves are dominated by probe-schedule luck, and the multiply is
  where the candidates actually differ;
* results persist to a JSON cache keyed on (pattern hash, LM, LN,
  precision, device kind), so a production service pays the measurement
  once per operator pattern.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from .bsr import Bsr
from .cache import checkout_dir
from .solver import Solver


def _cache_path() -> str:
    d = os.environ.get("TFQ_AUTOTUNE_CACHE") or os.path.join(
        checkout_dir(), ".autotune")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "autotune.json")


def _pattern_key(plan, lm: int, ln: int, precision: str) -> str:
    import jax

    dev = jax.devices()[0]
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(plan.pairs).tobytes())
    h.update(np.ascontiguousarray(plan.colindx).tobytes())
    h.update(f"{lm}:{ln}:{precision}:"
             f"{getattr(dev, 'device_kind', dev.platform)}".encode())
    return h.hexdigest()[:24]


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _store_cache(key: str, entry: dict) -> None:
    cache = _load_cache()
    cache[key] = entry
    try:
        with open(_cache_path(), "w") as f:
            json.dump(cache, f, indent=1)
    except OSError:
        pass


def time_multiply(solver: Solver, nrep: int = 16, repeats: int = 2) -> float:
    """Best-of-``repeats`` wall time of ONE multiply on the solver's
    engine: a jitted chain of ``nrep`` multiplies with a renormalization
    between steps, timed to ``block_until_ready``."""
    import jax
    import jax.numpy as jnp

    apply = solver._apply_a

    @jax.jit
    def chain(x):
        def body(_, x):
            y = apply(x)
            s = 1.0 / jnp.maximum(jnp.max(jnp.abs(y[0])), 1e-30)
            return (y[0] * s, y[1] * s)

        return jax.lax.fori_loop(0, nrep, body, x)

    x0 = solver._v3
    jax.block_until_ready(chain(x0))                 # compile + warm
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x0))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best / nrep


def default_candidates(lm: int, ln: int) -> list:
    """Engine candidates: 'dense', 'xla', and the pair-walk kernel where it
    compiles (a GPU and a block shape it takes)."""
    import jax

    from .ops import pairwalk

    cands = ["dense", "xla"]
    if jax.default_backend() == "gpu" and pairwalk.supports(lm, ln):
        cands.append("pairs")
    return cands


def autotune_solver(a: Bsr, x: Bsr, b: Bsr, *, precision: str = "c",
                    candidates: Optional[list] = None,
                    nrep: int = 16, use_cache: bool = True,
                    echo: int = 0, **solver_kw):
    """Measure candidate engines on the ISOLATED multiply; return
    (best_solver, table).  Results persist across processes keyed on the
    operator pattern (see module docstring); a cache hit builds the winning
    engine directly without re-measuring.  ``solver_kw`` goes to every
    ``Solver`` (e.g. ``interpret=True`` for the kernel on the CPU)."""
    probe = Solver(a, x, b, precision=precision, engine="xla", echo=0)
    if candidates is None:
        candidates = default_candidates(probe.lm, probe.ln)
    key = _pattern_key(probe.plan, probe.lm, probe.ln, precision)
    if use_cache:
        hit = _load_cache().get(key)
        if hit is not None:
            s = Solver(a, x, b, precision=precision, engine=hit["engine"],
                       echo=echo, plan=probe.plan, **solver_kw)
            if echo > 0:
                print(f"# autotune: cache hit {hit['engine']} "
                      f"({hit.get('ms_per_multiply', '?')} ms/multiply)")
            return s, [dict(**hit, cached=True)]

    table = []
    best = None
    for engine in candidates:
        try:
            s = Solver(a, x, b, precision=precision, engine=engine,
                       echo=echo, **solver_kw)
            dt = time_multiply(s, nrep=nrep)
        except Exception as e:            # engine not applicable
            table.append(dict(engine=engine,
                              error=f"{type(e).__name__}: {e}"))
            if echo > 0:
                print(f"# autotune: {engine} unavailable ({e})")
            continue
        row = dict(engine=engine, ms_per_multiply=round(dt * 1e3, 4))
        table.append(row)
        if echo > 0:
            print(f"# autotune: {engine} -> {dt*1e3:.3f} ms/multiply")
        if best is None or dt < best[1]:
            best = (s, dt, row)
    if best is None:
        raise RuntimeError("no engine configuration succeeded")
    if use_cache:
        _store_cache(key, best[2])
    return best[0], table
