"""The reference side of test_torch_committed.py: the reference's setup
and `prove_committed` (random.Random(11), r = 5, s = 9) of the lookup
range circuit give tests/vectors/committed_bn254.json, the key and
proof the port is held to."""

import torch_committed_cases as cc


def test_reference_key_and_proof_equal_the_vector():
    assert cc.reference_vector() == cc.vector()
