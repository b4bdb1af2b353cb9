"""The reference's sequencer with its `ProtocolProvers` at its CPU prover
tier on the toy 2-chain (tests/torch_pipeline_cases.py): the record
`PROVER_REFERENCE`, which the port's run in
test_torch_pipeline_provers.py must equal.
"""

import pytest
import torch
from torch_pipeline_cases import (  # noqa: F401  (the shared checks)
    prover_election,
    test_prover_c4_solves_one_ballot_in_two_slots,
    test_prover_election_equals_the_recorded_run,
    test_prover_vote_proof_verifies_and_pads_c3,
)

torch.set_num_threads(1)

PKG = "davinci_tpu"


@pytest.fixture(scope="module")
def prover(tmp_path_factory):
    record, election = prover_election(
        PKG, tmp_path_factory.mktemp("artifacts"))
    return PKG, record, election
