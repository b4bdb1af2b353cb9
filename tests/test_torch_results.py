"""The results verifier (c5, `circuits/results.py`, a verbatim copy) at
full size (64 levels, 8 fields), built by the port from the state its
seeded election leaves (tests/torch_c4_cases.py): its counts, public
values and structure hash are the reference's build (`C5_REFERENCE`,
which test_torch_results_ref.py makes again); it is satisfiable, and
unsatisfiable with a wrong result or a wrong state root, as
tests/test_results_circuit.py:36-62.
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

PKG = "davinci_tpu_torch"


@pytest.fixture(scope="module")
def c5():
    return (PKG, *build_c5(PKG))
