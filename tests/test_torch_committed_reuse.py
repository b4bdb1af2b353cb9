"""davinci_tpu_torch's steady-state `prove_committed_reuse` of a committed
BN254 circuit, on the CPU.

With the reference's key carried across by `convert.py` (equal to the
port's own setup: test_torch_committed_setup.py), a re-proof of an
already built system (a fresh blind, the challenge's wires re-solved in
place, no circuit build) verifies and commits to the D of a host MSM of
its committed wires (tests/test_lookup.py:133).
"""

import random

import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16

torch.set_num_threads(1)


def _build(CS, Checker, challenge, blind):
    cs = CS(RF.BN254_R)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=2)
    for v in (3, 1, 2, 0):
        rc.range_check(cs.priv_input(v), 2)
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(7))
    return cs


def test_prove_committed_reuse_verifies():
    port = Groth16("bn254", device="cpu")
    ref_pk, ref_vk = RefGroth16("bn254").setup(_build(RefCS, RefChecker, 0, 0))
    pk = convert.proving_key_from_reference(ref_pk, port.g1, port.g2)
    vk = convert.verifying_key_from_reference(ref_vk, port.g1, port.g2)
    cs = _build(ConstraintSystem, LookupRangeChecker, 0, 1)
    blind_before = cs.values[cs.committed[-1]]
    proof = port.prove_committed_reuse(pk, cs, rng=random.Random(31),
                                       r_rand=5, s_rand=9)
    assert cs.values[cs.committed[-1]] != blind_before  # a fresh blind
    assert cs.values[cs.challenge_idx] == port.commitment_challenge(proof.d)
    assert port.verify_committed(vk, proof, [7])
    # D over the commitment basis, as a host MSM of the committed wires
    bases = pk.k_commit_g1.to_host_points(port.dc)
    want = port.g1.infinity()
    for pt, v in zip(bases, (cs.values[i] for i in cs.committed)):
        want = want.add(pt.mul(v))
    assert proof.d == want
