"""The XLA block-list multiply at every block size the reference compiles,
in both precisions, against the NumPy pair walk."""

import pytest

from blocksize_cases import SIZES, spmm_parity


@pytest.mark.parametrize("prec", ["c", "z"])
@pytest.mark.parametrize("lm,ln", SIZES)
def test_spmm_parity_xla(rng, lm, ln, prec):
    spmm_parity(rng, lm, ln, prec)
