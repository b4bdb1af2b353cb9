"""The port's sequencer with its `ProtocolProvers` (`sequencer/provers.py`,
a verbatim copy) at the reference's CPU prover tier, on the toy 2-chain
(tests/torch_pipeline_cases.py): the toy vote verifier (c2) lite set up
and proved on the CPU through the port's `ArtifactStore` and Groth16,
the aggregator (c3) and the state transition (c4) built and solved, for
one ballot in two slots.  The vote hash, batch hash, c4's public values,
the `solved` flags, roots, blob and results equal the reference's
recorded run (`PROVER_REFERENCE`, which test_torch_pipeline_provers_ref.py
makes again); the c2 proof passes `verify_vote` and a tampered vote hash
does not.  One module-scoped election serves every test: its CPU setup
and two proves (the ballot's and the dummy vote's) take about 80 s, c4's
build and solve about 65 s.
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

PKG = "davinci_tpu_torch"


@pytest.fixture(scope="module")
def prover(tmp_path_factory):
    record, election = prover_election(
        PKG, tmp_path_factory.mktemp("artifacts"), {"device": "cpu"})
    return PKG, record, election
