"""The reference's build of the small-tier state transition (c4) from its
own seeded election (tests/torch_c4_cases.py): the record
`SMALL_REFERENCE`, which the port's build in
test_torch_statetransition.py must equal (the two builds run in two
files to spread them over workers); satisfiable, and unsatisfiable with
root_after + 1, a tampered re-encryption or a tampered inputs hash.
"""

import pytest
import torch
from torch_c4_cases import (  # noqa: F401  (the shared checks)
    build_c4,
    test_small_c4_equals_the_recorded_build,
    test_small_c4_is_satisfiable,
    test_small_c4_publics_are_the_batch_and_the_blob,
    test_small_c4_root_after_plus_one_is_unsatisfiable,
    test_small_c4_tampered_inputs_hash_is_unsatisfiable,
    test_small_c4_tampered_reencryption_is_unsatisfiable,
)

torch.set_num_threads(1)

PKG = "davinci_tpu"


@pytest.fixture(scope="module")
def c4():
    return (PKG, *build_c4(PKG))
