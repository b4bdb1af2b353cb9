"""The reference side of test_torch_aggregator.py: the reference's own
build of the one-slot aggregator from the vector equals
`torch_c3_cases.AGG_REFERENCE`, and the vector's committed proof
verifies under its key in the reference (host pairing checks) for the
vote hash 7 and not for 8 (test_torch_aggregator.py checks the port's
`verify_committed` on it)."""

import torch

import torch_c3_cases as c3

torch.set_num_threads(1)


def test_reference_build_equals_the_record():
    cs = c3.build("davinci_tpu")
    assert c3.fingerprint("davinci_tpu", cs) == c3.AGG_REFERENCE


def test_vector_proof_verifies_in_the_reference():
    from davinci_tpu.groth16 import Groth16

    g16 = Groth16("bls12_377")
    vk, proof = c3.inner_key_and_proof("davinci_tpu")
    assert g16.verify_committed(vk, proof, [c3.VOTE_HASH])
    assert not g16.verify_committed(vk, proof, [c3.VOTE_HASH + 1])
