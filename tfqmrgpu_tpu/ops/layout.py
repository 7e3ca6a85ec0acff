"""Data-layout conversion between host formats and the device representation.

The device representation is a pair of real planes ``(re, im)``, each of
shape ``[nnzb, LM, LN]`` -- the equivalent of the reference's
native RRRRIIII layout (tfqmrgpu.h:184).  Host-side users typically hold
either NumPy complex arrays or RIRIRIRI-interleaved real arrays (the
reference's default host layout, tfqmrgpu.h:186); the converters here cover
the full setMatrix/getMatrix semantic surface: layout, per-block transpose,
conjugation and global scaling (reference: tfqmrgpu.cu:467-645
set_or_getMatrix + transpose_blocks_kernel in tfqmrgpu_linalg.hxx:282-380).

Unlike the reference, blocks of A are NOT silently stored transposed on
device -- the engines consume natural row-major blocks (the pair-walk
kernel transposes its own f64 copy), so 'n'/'t' mean exactly what the user
wrote.
"""

from __future__ import annotations

import numpy as np

from ..errors import Status, TfqmrgpuError, encode_status

LAYOUT_RRRRIIII = 0x0F
LAYOUT_RRIIRRII = 0x33
LAYOUT_RIRIRIRI = 0x55

_LAYOUTS = (LAYOUT_RRRRIIII, LAYOUT_RRIIRRII, LAYOUT_RIRIRIRI)


def resolve_transposition(trans: str, conjugate: bool = False):
    """Resolve a reference transposition char into (trans, conjugate).

    Accepts (case-insensitively) 'n', 't', 'h'/'c' (transpose + conjugate,
    the LAPACK Hermitian adjoint) and '*' (conjugate only), exactly as
    tfqmrgpu.cu:492-500 resolves them into a 'n'/'t' flag plus an imaginary
    scale of -1.  An explicit ``conjugate`` request composes (XOR) with the
    conjugation implied by the char.
    """
    t = trans.lower() if isinstance(trans, str) else trans
    if t in ("h", "c"):
        return "t", (not conjugate)
    if t == "*":
        return "n", (not conjugate)
    if t in ("n", "t"):
        return t, conjugate
    raise TfqmrgpuError(
        encode_status(Status.TANSPOSITION_UNKNOWN, 0, trans if isinstance(trans, str) and len(trans) == 1 else "?"),
        f"trans={trans!r}")


def to_planes(
    val: np.ndarray,
    nnzb: int,
    ld: int,
    d2: int,
    trans: str = "n",
    layout: int = LAYOUT_RIRIRIRI,
    conjugate: bool = False,
    scale: float = 1.0,
    dtype=np.float64,
):
    """Convert a host block array into device re/im planes.

    Args:
      val: real array whose flat length is ``nnzb * ld * d2 * 2`` (real+imag),
        or a complex array of shape ``[nnzb, ld, d2]``.
      ld, d2: slow/fast block dims as stored in ``val``.
      trans: 'n' keeps blocks as [ld, d2]; 't' transposes each block (the
        result block shape is then [d2, ld]); 'h'/'c' = transpose +
        conjugate; '*' = conjugate only (tfqmrgpu.cu:492-500).
      layout: one of the three reference layouts for real-valued input.
      conjugate: negate the imaginary part.
      scale: global real scaling factor.

    Returns:
      (re, im): np arrays of shape [nnzb, slow, fast] in ``dtype``.
    """
    trans, conjugate = resolve_transposition(trans, conjugate)
    val = np.asarray(val)
    if np.iscomplexobj(val):
        blocks = val.reshape(nnzb, ld, d2)
        re = blocks.real.astype(dtype)
        im = blocks.imag.astype(dtype)
    else:
        flat = val.reshape(-1)
        if flat.size != nnzb * ld * d2 * 2:
            raise TfqmrgpuError(
                encode_status(Status.UNDOCUMENTED_ERROR),
                f"value array has {flat.size} reals, expected {nnzb * ld * d2 * 2}",
            )
        if layout == LAYOUT_RIRIRIRI:
            b = flat.reshape(nnzb, ld, d2, 2)
            re, im = b[..., 0], b[..., 1]
        elif layout == LAYOUT_RRRRIIII:
            b = flat.reshape(nnzb, 2, ld, d2)
            re, im = b[:, 0], b[:, 1]
        elif layout == LAYOUT_RRIIRRII:
            b = flat.reshape(nnzb, ld, 2, d2)
            re, im = b[:, :, 0], b[:, :, 1]
        else:
            raise TfqmrgpuError(encode_status(Status.DATALAYOUT_UNKNOWN),
                                f"layout=0x{layout:x}")
        re = re.astype(dtype)
        im = im.astype(dtype)
    if trans == "t":
        re = np.swapaxes(re, 1, 2)
        im = np.swapaxes(im, 1, 2)
    sign = -1.0 if conjugate else 1.0
    if scale != 1.0 or conjugate:
        re = re * scale
        im = im * (sign * scale)
    return np.ascontiguousarray(re), np.ascontiguousarray(im)


def from_planes(
    re: np.ndarray,
    im: np.ndarray,
    trans: str = "n",
    layout: int = LAYOUT_RIRIRIRI,
    conjugate: bool = False,
    dtype=np.float64,
):
    """Convert device re/im planes back to a host real array in ``layout``
    (the getMatrix('X') direction, tfqmrgpu.cu:624-645).  ``trans``
    accepts the full 'n'/'t'/'h'/'c'/'*' vocabulary."""
    trans, conjugate = resolve_transposition(trans, conjugate)
    re = np.asarray(re, dtype=dtype)
    im = np.asarray(im, dtype=dtype)
    if trans == "t":
        re = np.swapaxes(re, 1, 2)
        im = np.swapaxes(im, 1, 2)
    if conjugate:
        im = -im
    if layout == LAYOUT_RIRIRIRI:
        return np.ascontiguousarray(np.stack([re, im], axis=-1))
    if layout == LAYOUT_RRRRIIII:
        return np.ascontiguousarray(np.stack([re, im], axis=1))
    if layout == LAYOUT_RRIIRRII:
        return np.ascontiguousarray(np.stack([re, im], axis=2))
    raise TfqmrgpuError(encode_status(Status.DATALAYOUT_UNKNOWN),
                        f"layout=0x{layout:x}")


def planes_to_complex(re, im) -> np.ndarray:
    re = np.asarray(re)
    cdtype = np.complex128 if re.dtype == np.float64 else np.complex64
    return np.asarray(re).astype(cdtype) + 1j * np.asarray(im).astype(cdtype)


def complex_to_planes(c, dtype=None):
    c = np.asarray(c)
    if dtype is None:
        dtype = np.float64 if c.dtype == np.complex128 else np.float32
    return (np.ascontiguousarray(c.real.astype(dtype)),
            np.ascontiguousarray(c.imag.astype(dtype)))
