"""Device wiring: the GPU smoke check refuses the CPU, the compile cache
stays in one place, the peaks table is keyed by device kind, and no
engine choice falls back to an interpreted kernel."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import tfqmrgpu_tpu as tq
from tfqmrgpu_tpu import cache, profiling

from conftest import make_random_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return env


def test_chip_smoke_refuses_cpu():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=_cpu_env(), cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stdout


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    # with the variable set, the code sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_h100_peaks_lookup():
    p = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["fp64_tensor_tflops"] == 67.0 and p["hbm_gbps"] == 3350.0
    assert p["tf32_tflops"] == 495.0 and p["fp32_tflops"] == 67.0


def test_unknown_device_peaks_raise():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks("cpu")


def test_auto_never_picks_an_interpreted_kernel():
    import chip_smoke

    assert chip_smoke.check_auto_routing() == {8: "xla", 32: "xla"}


def test_pairs_engine_needs_gpu_or_interpret(rng):
    a, x, b = make_random_problem(rng, mb=6, lm=16, ln=16, ncols=2,
                                  x_fill=1.0, dtype=np.complex64)
    with pytest.raises(tq.TfqmrgpuError, match="GPU only"):
        tq.Solver(a, x, b, precision="c", engine="pairs")
    s = tq.Solver(a, x, b, precision="c", engine="pairs", interpret=True)
    assert s.engine == "pairs" and s.interpret


def test_device_record_names_the_platform():
    rec = profiling.device_record()
    assert rec == dict(platform="cpu", kind=jax.devices()[0].device_kind,
                       count=len(jax.devices()))
    json.dumps(rec)
