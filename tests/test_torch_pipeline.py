"""The sequencer pipeline of the port (`sequencer/pipeline.py`,
`storage/`, verbatim copies) driven by `DevStubProvers` through the
seeded election of tests/torch_pipeline_cases.py: its vote statuses
after every tick, roots, chain transitions, blobs and their
`parse_blob_data`, results and counters equal the reference's recorded
run (`STUB_REFERENCE`, which test_torch_pipeline_ref.py makes again),
with a batch of fewer ballots than slots and a refused transition rolled
back.  The persistent queues: `Storage` over `SQLiteKV` writes the
reference's keys and values, and a reopened file resumes them.  The CSP
census branch (`csp.py`) on a proof the reference's CSP key signs.
"""

import importlib

import pytest
import torch
from torch_pipeline_cases import (  # noqa: F401  (the shared checks)
    stub_election,
    test_stub_election_equals_the_recorded_run,
    test_stub_election_settles_and_tallies,
    test_stub_refused_transition_rolls_back,
)

torch.set_num_threads(1)

PKG = "davinci_tpu_torch"


@pytest.fixture(scope="module")
def stub():
    return PKG, stub_election(PKG)


def queues(pkg, path):
    """Ballots pushed, reserved, done and released on `Storage` over
    `SQLiteKV` at `path`, one vote status walked to SETTLED: every key
    and value of the file."""
    storage = importlib.import_module(f"{pkg}.storage")
    kv = storage.SQLiteKV(str(path))
    st = storage.Storage(kv)
    for i in range(3):
        st.pending_ballots.push({"pid": 9, "vote_id": 100 + i, "n": [i, "x"]})
        st.set_vote_status(9, 100 + i, storage.VoteIDStatus.PENDING)
    (s0, _), (s1, _) = st.pending_ballots.next(2)
    st.pending_ballots.done(s0)
    st.pending_ballots.release(s1)
    S = storage.VoteIDStatus
    for status in (S.VERIFIED, S.AGGREGATED, S.PROCESSED, S.SETTLED):
        st.set_vote_status(9, 100, status)
    with pytest.raises(ValueError):  # the status machine has no way back
        st.set_vote_status(9, 100, S.PENDING)
    st.bump_stat(9, "verified_votes", 2)
    rows = [(k, v) for k, v in kv.iter_prefix(b"")
            if not k.startswith(b"r/")]  # reservations carry a clock
    kv.close()
    return rows


def test_sqlite_queues_equal_the_reference_and_resume(tmp_path):
    storage = importlib.import_module(f"{PKG}.storage")
    rows = queues(PKG, tmp_path / "port.db")
    assert rows == queues("davinci_tpu", tmp_path / "ref.db")
    st = storage.Storage(storage.SQLiteKV(str(tmp_path / "port.db")))
    assert st.pending_ballots.size() == 2
    assert [it["vote_id"] for _, it in st.pending_ballots.next(5)] == [101,
                                                                       102]
    assert st.vote_status(9, 100) == storage.VoteIDStatus.SETTLED
    assert st.stats(9) == {"verified_votes": 2}


def test_csp_census_branch_equals_the_reference():
    """The pipeline's CSP census branch (`csp_circuit_proof`,
    `pipeline.py:336-339`) on a proof the reference's CSP key signs (the
    key schedule needs `hash/blake512.py`, which the port does not
    carry): the circuit form, the message and the verification equal
    the reference's, and a tampered weight is refused."""
    from davinci_tpu import csp as ref
    from davinci_tpu_torch import csp

    proof = ref.BabyJubJubEdDSA(b"census").generate_proof(
        9, 0xA11CE, 3, voter_index=5)
    wire = {**proof, "signature": {"r8x": str(proof["signature"].r8[0]),
                                   "r8y": str(proof["signature"].r8[1]),
                                   "s": str(proof["signature"].s)}}
    for p in (proof, wire):
        assert csp.csp_circuit_proof(p) == ref.csp_circuit_proof(p)
    assert csp.csp_message(5, 9, 0xA11CE, 3) == ref.csp_message(5, 9, 0xA11CE,
                                                                 3)
    assert csp.BabyJubJubEdDSA.verify_proof(proof)
    assert not csp.BabyJubJubEdDSA.verify_proof({**proof, "weight": 4})
