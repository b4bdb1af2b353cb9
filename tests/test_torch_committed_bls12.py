"""Committed Groth16 on BLS12-377 in davinci_tpu_torch, held against the
JAX package on the CPU.

BLS12-377 (the vote verifier's curve) proves committed: a chain of two
emulated products whose limbs are range-checked through the lookup (the
arithmetic of the vote verifier, here modulo 13 on two 2-bit limbs with
a 4-entry table: 91 constraints; `torch_c3_cases.inner_circuit`).  With
the reference's key of it (tests/vectors/c3_inner_bls12_377.json, read
by the port's `pk_from_bytes` and `vk_from_bytes`), random.Random(11),
r = 5 and s = 9, the port's `prove_committed` gives the reference's
proof of that vector point for point (a, b, c, D and pok), and D and
pok equal host MSMs of the committed wires over the key's commitment
bases.  The builder also sets the `_refinalize` hook: one build.  One
port CPU prove: about 20-25 s.  `verify_committed` of both packages on
those points (the vector's) is held in test_torch_aggregator.py and
test_torch_aggregator_ref.py, true for 7 and false for 8.
"""

import json
import random

import pytest
import torch

from davinci_tpu_torch.groth16 import Groth16
from davinci_tpu_torch.groth16.serialize import pk_from_bytes, proof_to_dict

import torch_c3_cases as c3

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bls377():
    port = Groth16("bls12_377", device="cpu")
    vector = json.loads(c3.VECTOR.read_text())
    tpk = pk_from_bytes(bytes.fromhex(vector["pk"]), port.g1, port.g2)
    builds, built = [], []

    def build(challenge, blind):
        builds.append(challenge)
        cs = c3.inner_circuit("davinci_tpu_torch", challenge, blind)
        built.append(cs)
        return cs

    proof = port.prove_committed(tpk, build, rng=random.Random(11),
                                 r_rand=5, s_rand=9)
    return dict(port=port, vector=vector, tpk=tpk, proof=proof,
                builds=builds, cs=built[0])


def test_bls12_377_committed_proof_equals_the_reference(bls377):
    k = bls377
    assert k["builds"] == [0]
    assert proof_to_dict(k["proof"]) == k["vector"]["proof"]


@pytest.mark.parametrize("basis, part", [("k_commit_g1", "d"),
                                         ("k_commit_eta_g1", "pok")])
def test_bls12_377_commitment_equals_host_msm(bls377, basis, part):
    k = bls377
    port, cs = k["port"], k["cs"]
    bases = getattr(k["tpk"], basis).to_host_points(port.dc)
    want = port.g1.infinity()
    for pt, i in zip(bases, cs.committed):
        want = want.add(pt.mul(cs.values[i]))
    assert len(bases) == len(cs.committed) > 10
    assert getattr(k["proof"], part) == want
