"""The commitment extension of davinci_tpu_torch's Groth16 held against the
JAX package on BN254, on the CPU.

The lookup range circuit of tests/test_lookup.py (`torch_committed_cases`,
a 4-entry table so the CPU proves stay cheap).  With the reference's key
(tests/vectors/committed_bn254.json, read by the port's `pk_from_bytes`),
random.Random(11), r = 5 and s = 9, the port's `prove_committed` gives
the reference's proof point for point (a, b, c, D and pok): the
vector's, which test_torch_committed_ref.py holds the reference's own
setup and prove to.  The challenge and the refusals, verification, the
`_refinalize` hook, setup and `prove_committed_reuse` are held in
test_torch_committed_challenge.py, _verify.py, _setup.py and _reuse.py:
one CPU prove costs about 15 s, so each file holds one.
"""

import pytest
import torch

from davinci_tpu_torch.groth16 import CommittedProof, Groth16
from davinci_tpu_torch.groth16.serialize import pk_from_bytes, proof_to_dict

import torch_committed_cases as cc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    """The port's proof with the reference's key, and the reference's
    proof (the vector's)."""
    port = Groth16("bn254", device="cpu")
    want = cc.vector()
    pk = pk_from_bytes(bytes.fromhex(want["pk"]), port.g1, port.g2)
    return dict(want=want["proof"],
                got=cc.prove("davinci_tpu_torch", port, pk))


@pytest.mark.parametrize("part", ["a", "b", "c", "d", "pok"])
def test_committed_proof_equals_reference(run, part):
    assert isinstance(run["got"], CommittedProof)
    assert proof_to_dict(run["got"])[part] == run["want"][part]
