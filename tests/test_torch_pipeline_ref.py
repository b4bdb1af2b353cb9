"""The reference's sequencer pipeline driven by `DevStubProvers` through
the seeded election of tests/torch_pipeline_cases.py: the record
`STUB_REFERENCE`, which the port's run in test_torch_pipeline.py must
equal (the two runs are in two files to spread them over workers).
"""

import pytest
import torch
from torch_pipeline_cases import (  # noqa: F401  (the shared checks)
    stub_election,
    test_stub_election_equals_the_recorded_run,
    test_stub_election_settles_and_tallies,
    test_stub_refused_transition_rolls_back,
)

torch.set_num_threads(1)

PKG = "davinci_tpu"


@pytest.fixture(scope="module")
def stub():
    return PKG, stub_election(PKG)
