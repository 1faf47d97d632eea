"""Port parity, the backward over per-tile candidate lists that really
truncate: the lattice cases of ``test_torch_vjp`` (8 of 64 well-separated
tori per tile, certified, alone and under a smooth union), held against
``jax.grad`` on "pallas_interpret" leaf by leaf within 1e-5 of the leaf's
max |g|, with the ``point_eval`` route asserted.  A file of its own so that
the cases spread over test workers.  Every tensor is on the CPU.
"""
import pytest

from test_torch_vjp import LATTICE_CASES, check_backward_against_jax


@pytest.mark.parametrize("case", LATTICE_CASES)
def test_backward_over_truncated_lists_matches_jax_vjp(case):
    check_backward_against_jax(case)
