"""The aggregator (c3, BW6-761) in davinci_tpu_torch: the port's copy of
`circuits/aggregator.py` builds, from the reference's committed
BLS12-377 key and proof (tests/vectors/c3_inner_bls12_377.json), the
system the reference builds: the same constraint and variable counts,
batch hash and structure hash (`torch_c3_cases.AGG_REFERENCE`, which
test_torch_aggregator_ref.py holds the reference's own build to), and
it is satisfied; the port's `verify_committed` accepts the vector's
proof for the vote hash 7 and refuses it for 8.  The production shape (`inner_committed=True`, the
31-byte keccak batch hash) at one slot: about 10-20 s a build here.

With RUN_SLOW_TESTS, the latch-mask and wrong-vote-hash cases of
tests/test_aggregator_circuit.py:70-99 on the port's build (three slots
for the latch).
"""

import os

import pytest
import torch

from davinci_tpu_torch.circuits.aggregator import batch_hash

import torch_c3_cases as c3

torch.set_num_threads(1)

PKG = "davinci_tpu_torch"


def test_port_build_equals_the_reference_and_is_satisfied():
    cs = c3.build(PKG)
    assert c3.fingerprint(PKG, cs) == c3.AGG_REFERENCE
    params, w = c3.aggregator_inputs(PKG)
    assert cs.num_public == 1
    assert cs.public_values() == [batch_hash(params, w)]
    assert cs.check_satisfied()


def test_vector_proof_verifies_in_the_port():
    from davinci_tpu_torch.groth16 import Groth16

    g16 = Groth16("bls12_377", device="cpu")
    vk, proof = c3.inner_key_and_proof(PKG)
    assert g16.verify_committed(vk, proof, [c3.VOTE_HASH])
    assert not g16.verify_committed(vk, proof, [c3.VOTE_HASH + 1])


slow = pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="more aggregator builds; set RUN_SLOW_TESTS=1")


@slow
def test_latch_mask_is_enforced():
    """One real vote in three slots: the mask 1, 0, 1 breaks the latch
    (once off, a mask bit stays off)."""
    cs = c3.build(PKG, n_votes=3)
    assert cs.check_satisfied()
    idx = 4  # [one, batch hash, mask0, mask1, mask2, ...]
    assert cs.values[2:5] == [1, 0, 0]
    cs.values[idx] = 1
    assert not cs.check_satisfied()


@slow
def test_wrong_vote_hash_is_rejected():
    with pytest.raises(AssertionError):
        c3.build(PKG, vote_hash=c3.VOTE_HASH + 1)
