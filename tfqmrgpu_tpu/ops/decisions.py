"""The three tfQMR scalar decision updates.

These act on per-RHS scalar fields of shape ``[nCols, LN]`` -- one logical
scalar recurrence per right-hand side.  The reference runs them as tiny
<<<nCols, LN>>> kernels with one thread per RHS (tfqmrgpu_linalg.hxx:31-254);
here they are branchless jnp expressions fused into the iteration body.

All intermediate arithmetic is float64, matching the reference (which casts
real_t scalars to double inside the kernels); results are cast back to the
data precision where the reference stores real_t.

Status codes per RHS (int8 semantics):  0 iterating, 1 converged,
-1 dec35 breakdown, -2 dec34 breakdown, -3 stagnation/early convergence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# reference: #define EPSILON 2.5e-308 (tfqmrgpu_linalg.hxx:31) -- the
# reference always computes scalars in double; without x64 the scalar path
# runs in float32, where the guard must sit above the f32 underflow floor.
EPSILON = 2.5e-308
EPSILON_F32 = 1e-35
# the reference's convergence-probe constants (tfqmrgpu_core.hxx):
# residual2 starts at DBL_MAX/8 and is floored at 1.4e-76; without x64 the
# float32 path keeps representable values
RESIDUAL2_INIT = float(np.finfo(np.float64).max) / 8
RESIDUAL2_INIT_F32 = 1e30
RESIDUAL_FLOOR = 1.4e-76

Pair = tuple


def scalar_dtype():
    """The dtype of the scalar recurrences: float64 when x64 is enabled
    (reference semantics), float32 otherwise."""
    return jax.dtypes.canonicalize_dtype(np.float64)


def breakdown_eps():
    """Breakdown guard for |rho|^2/|z|^2/tau: the reference's EPSILON in
    float64, a value above the float32 underflow floor when x64 is off."""
    if scalar_dtype() != jnp.float64:
        return EPSILON_F32
    return EPSILON


def initial_residual2():
    """Start value of the probed max residual^2."""
    if scalar_dtype() != jnp.float64:
        return RESIDUAL2_INIT_F32
    return RESIDUAL2_INIT


def residual_floor():
    """Underflow guard of the probed max residual^2."""
    if scalar_dtype() != jnp.float64:
        return EPSILON_F32
    return RESIDUAL_FLOOR


def _f64(x):
    return x.astype(scalar_dtype())


def _abs2(re, im):
    return re * re + im * im


def dec35(status, rho: Pair, z35: Pair, out_dtype):
    """beta := z35 / rho;  rho := z35;  breakdown -> status -1, beta=rho=0.

    Reference: tfQMRdec35_kernel (tfqmrgpu_linalg.hxx:34-78).
    Returns (status, rho, beta).
    """
    eps = breakdown_eps()
    rho_re, rho_im = _f64(rho[0]), _f64(rho[1])
    z_re, z_im = z35
    abs2z = _abs2(z_re, z_im)
    abs2rho = _abs2(rho_re, rho_im)
    # ~isfinite: insurance against overflowed upstream scalars, which must
    # freeze the RHS, not poison it
    breakdown = ((abs2z < eps) | (abs2rho < eps)
                 | ~jnp.isfinite(abs2z) | ~jnp.isfinite(abs2rho))
    denom = 1.0 / jnp.where(breakdown, 1.0, _abs2(rho_re, rho_im))
    bet_re = (z_re * rho_re + z_im * rho_im) * denom
    bet_im = (z_im * rho_re - z_re * rho_im) * denom
    zero = jnp.zeros_like(z_re)
    new_status = jnp.where(breakdown, jnp.int32(-1), status)
    beta = (jnp.where(breakdown, zero, bet_re).astype(out_dtype),
            jnp.where(breakdown, zero, bet_im).astype(out_dtype))
    new_rho = (jnp.where(breakdown, zero, z_re).astype(out_dtype),
               jnp.where(breakdown, zero, z_im).astype(out_dtype))
    return new_status, new_rho, beta


def dec34(status, rho: Pair, eta: Pair, z34: Pair, var, out_dtype):
    """alfa := -rho / z34;  c67 := z34 * (var * eta / rho);
    breakdown -> status -2, alfa=c67=0.

    Reference: tfQMRdec34_kernel (tfqmrgpu_linalg.hxx:97-154).
    Returns (status, c67, alfa).
    """
    eps = breakdown_eps()
    rho_re, rho_im = _f64(rho[0]), _f64(rho[1])
    eta_re, eta_im = _f64(eta[0]), _f64(eta[1])
    z_re, z_im = z34
    abs2rho = _abs2(rho_re, rho_im)
    abs2z34 = _abs2(z_re, z_im)
    breakdown = ((abs2z34 < eps) | (abs2rho < eps)
                 | ~jnp.isfinite(abs2z34) | ~jnp.isfinite(abs2rho)
                 | ~jnp.isfinite(var))
    z_denom = -1.0 / jnp.where(breakdown, 1.0, abs2z34)
    alf_re = (rho_re * z_re + rho_im * z_im) * z_denom
    alf_im = (rho_im * z_re - rho_re * z_im) * z_denom
    vrho_denom = var / jnp.where(breakdown, 1.0, abs2rho)
    tmp_re = (eta_re * rho_re + eta_im * rho_im) * vrho_denom
    tmp_im = (eta_im * rho_re - eta_re * rho_im) * vrho_denom
    c67_re = z_re * tmp_re - z_im * tmp_im
    c67_im = z_im * tmp_re + z_re * tmp_im
    zero = jnp.zeros_like(z_re)
    new_status = jnp.where(breakdown, jnp.int32(-2), status)
    alfa = (jnp.where(breakdown, zero, alf_re).astype(out_dtype),
            jnp.where(breakdown, zero, alf_im).astype(out_dtype))
    c67 = (jnp.where(breakdown, zero, c67_re).astype(out_dtype),
           jnp.where(breakdown, zero, c67_im).astype(out_dtype))
    return new_status, c67, alfa


def dect(status, var, tau, alfa: Pair, d55, out_dtype, with_c67: bool):
    """The tau/var/eta update after each half-step.

    if |tau| > EPS:   var := d55/tau; cosi := 1/(1+var); tau := d55*cosi;
                      r67 := var*cosi
    else:             status := -3; var := tau := 0; cosi := 0; r67 stays 1
    eta := -cosi*alfa  where status >= 0 else 0
    c67 := (r67, 0)    only when with_c67 (the reference's optional out ptr)

    Reference: tfQMRdecT_kernel (tfqmrgpu_linalg.hxx:176-235).
    Returns (status, c67_or_None, eta, var, tau).
    """
    ok = (jnp.abs(tau) > breakdown_eps()) & jnp.isfinite(d55)
    safe_tau = jnp.where(ok, tau, 1.0)
    new_var_if = d55 / safe_tau
    cosi = jnp.where(ok, 1.0 / (1.0 + new_var_if), 0.0)
    new_var = jnp.where(ok, new_var_if, 0.0)
    new_tau = jnp.where(ok, d55 * cosi, 0.0)
    r67 = jnp.where(ok, new_var_if * cosi, 1.0)
    new_status = jnp.where(ok, status, jnp.int32(-3))
    neg = new_status < 0
    zero = jnp.zeros_like(cosi)
    eta = (jnp.where(neg, zero, -cosi * _f64(alfa[0])).astype(out_dtype),
           jnp.where(neg, zero, -cosi * _f64(alfa[1])).astype(out_dtype))
    c67 = (r67.astype(out_dtype), jnp.zeros_like(r67).astype(out_dtype)) \
        if with_c67 else None
    return new_status, c67, eta, new_var, new_tau
