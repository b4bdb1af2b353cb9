"""The state transition (c4, `circuits/statetransition.py` and its
gadgets, verbatim copies) built by the port from its own seeded election
(tests/torch_c4_cases.py), at the small tier: its counts, public values
and structure hash are the reference's build (`SMALL_REFERENCE`, which
test_torch_statetransition_ref.py makes again from the reference's own
election); it is satisfiable, and unsatisfiable with root_after + 1, a
tampered re-encryption or a tampered inputs hash.  RUN_SLOW_TESTS adds
the production tier at 2 votes (64 levels, census 20, the 4,096-cell
blob, lookups): the reference's 1,563,441 constraints, satisfiable.
"""

import os

import pytest
import torch
from torch_c4_cases import (  # noqa: F401  (the shared checks)
    PRODUCTION,
    PRODUCTION_CONSTRAINTS,
    build_c4,
    test_small_c4_equals_the_recorded_build,
    test_small_c4_is_satisfiable,
    test_small_c4_publics_are_the_batch_and_the_blob,
    test_small_c4_root_after_plus_one_is_unsatisfiable,
    test_small_c4_tampered_inputs_hash_is_unsatisfiable,
    test_small_c4_tampered_reencryption_is_unsatisfiable,
)

torch.set_num_threads(1)

PKG = "davinci_tpu_torch"


@pytest.fixture(scope="module")
def c4():
    return (PKG, *build_c4(PKG))


@pytest.mark.skipif(not os.environ.get("RUN_SLOW_TESTS"),
                    reason="a build of 1.56M constraints; set RUN_SLOW_TESTS=1")
def test_production_c4_at_two_votes_has_the_reference_count():
    cs, _, _ = build_c4(PKG, PRODUCTION)
    assert len(cs.constraints) == PRODUCTION_CONSTRAINTS
    assert cs.check_satisfied(), cs.first_unsatisfied()
