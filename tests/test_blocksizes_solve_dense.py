"""Solve parity of the 'dense' engine at every block size the reference
compiles (allowed_block_sizes.h:4-18), in both precisions, against a dense
NumPy solve."""

import pytest

from blocksize_cases import SIZES, solve_parity


@pytest.mark.parametrize("prec", ["c", "z"])
@pytest.mark.parametrize("lm,ln", SIZES)
def test_solve_parity_dense(rng, lm, ln, prec):
    solve_parity(rng, lm, ln, prec, "dense")
