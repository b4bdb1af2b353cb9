"""The reference's build of the full-size results verifier (c5) from its
own seeded election (tests/torch_c4_cases.py): the record
`C5_REFERENCE`, which the port's build in test_torch_results.py must
equal; satisfiable, and unsatisfiable with a wrong result or a wrong
state root.
"""

import pytest
import torch
from torch_c4_cases import (  # noqa: F401  (the shared checks)
    build_c5,
    test_c5_equals_the_recorded_build,
    test_c5_is_satisfiable_and_decrypts_the_votes,
    test_c5_wrong_result_is_unsatisfiable,
    test_c5_wrong_state_root_is_unsatisfiable,
)

torch.set_num_threads(1)

PKG = "davinci_tpu"


@pytest.fixture(scope="module")
def c5():
    return (PKG, *build_c5(PKG))
