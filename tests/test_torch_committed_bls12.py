"""Committed Groth16 on BLS12-377 in davinci_tpu_torch, held against the
JAX package on the CPU.

BLS12-377 (the vote verifier's curve) proves committed: a chain of two
emulated products whose limbs are range-checked through the lookup (the
arithmetic of the vote verifier, here modulo 13 on two 2-bit limbs with
a 4-entry table: 91 constraints, so the port's CPU prove takes about
25 s).  The reference's JAX prove of such a circuit takes about 36 s on
the CPU with a warm compile cache, so the port's proof is not compared
with it: the reference's host `verify_committed` accepts the port's
points, and D and pok equal host MSMs of the committed wires over the
key's commitment bases.  The builder also sets the `_refinalize` hook:
one build.
"""

import random

import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.emulated import EmulatedOps as RefEmulated
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.curves import AffinePoint as RefPoint
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16.core import CommittedProof as RefCommittedProof
from davinci_tpu.towers import FF as RefFF
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.emulated import EmulatedOps
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16

torch.set_num_threads(1)

EMU_P, LIMB_BITS, N_LIMBS = 13, 2, 2
A, B, CHAIN = 11, 6, 2


def committed_377(CS, Checker, Emulated, challenge, blind):
    """chip_smoke.py's committed-377 circuit at a CPU size: one public
    input, a chain of emulated products range-checked by lookups, its
    result asserted equal to the host's."""
    cs = CS(RF.BLS12_377_R)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=2)
    E = Emulated(cs, EMU_P, LIMB_BITS, N_LIMBS, range_checker=rc)
    acc, b = E.alloc(A), E.alloc(B)
    for _ in range(CHAIN):
        acc = E.mul(acc, b)
    E.assert_eq(acc, E.constant(A * pow(B, CHAIN, EMU_P) % EMU_P))
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(7))
    return cs


def point_to_reference(spec, pt):
    if pt.infinity:
        return spec.infinity()
    if hasattr(spec.fld, "p"):
        return RefPoint(spec, spec.fld(pt.x.v), spec.fld(pt.y.v))
    return RefPoint(spec, RefFF(spec.fld, tuple(pt.x.v)),
                    RefFF(spec.fld, tuple(pt.y.v)))


@pytest.fixture(scope="module")
def bls377():
    ref = RefGroth16("bls12_377")
    port = Groth16("bls12_377", device="cpu")
    pk, vk = ref.setup(committed_377(RefCS, RefChecker, RefEmulated, 0, 0))
    tpk = convert.proving_key_from_reference(pk, port.g1, port.g2)
    builds = []

    def build(challenge, blind):
        builds.append(challenge)
        cs = committed_377(ConstraintSystem, LookupRangeChecker, EmulatedOps,
                           challenge, blind)
        built.append(cs)
        return cs

    built = []
    proof = port.prove_committed(tpk, build, rng=random.Random(11),
                                 r_rand=5, s_rand=9)
    return dict(ref=ref, port=port, vk=vk, tpk=tpk, proof=proof,
                builds=builds, cs=built[0],
                tvk=convert.verifying_key_from_reference(vk, port.g1, port.g2))


def test_bls12_377_committed_proof_verifies_in_both_packages(bls377):
    k = bls377
    assert k["builds"] == [0]
    assert k["port"].verify_committed(k["tvk"], k["proof"], [7])
    g1, g2 = k["ref"].g1, k["ref"].g2
    p = k["proof"]
    ref_proof = RefCommittedProof(
        a=point_to_reference(g1, p.a), b=point_to_reference(g2, p.b),
        c=point_to_reference(g1, p.c), d=point_to_reference(g1, p.d),
        pok=point_to_reference(g1, p.pok))
    assert k["ref"].verify_committed(k["vk"], ref_proof, [7])


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
