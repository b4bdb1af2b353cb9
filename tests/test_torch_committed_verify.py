"""davinci_tpu_torch's committed BN254 proof through the `_refinalize` hook,
verified by both packages, on the CPU.

The lookup range circuit of tests/test_lookup.py (a 4-entry table) with
the hook attached: `prove_committed` builds it once and re-solves the
challenge's wires in place (tests/test_lookup.py:78).  With the
reference's key carried across, the proof verifies in both packages for
public 7 and fails for 8 (the reference verifies the port's points), and
fails with the proof of knowledge replaced by D.
"""

import random

import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.curves import AffinePoint as RefPoint
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16.core import CommittedProof as RefCommittedProof
from davinci_tpu.towers import FF as RefFF
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
from davinci_tpu_torch.groth16 import (CommittedProof, ConstraintSystem,
                                       Groth16)

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


def point_to_reference(spec, pt):
    """A port point on the reference's curve `spec`."""
    if pt.infinity:
        return spec.infinity()
    if hasattr(spec.fld, "p"):
        return RefPoint(spec, spec.fld(pt.x.v), spec.fld(pt.y.v))
    return RefPoint(spec, RefFF(spec.fld, tuple(pt.x.v)),
                    RefFF(spec.fld, tuple(pt.y.v)))


@pytest.fixture(scope="module")
def run():
    ref = RefGroth16("bn254")
    port = Groth16("bn254", device="cpu")
    pk, vk = ref.setup(_build(RefCS, RefChecker, 0, 0))
    builds = []

    def build(challenge, blind):
        builds.append(challenge)
        return _build(ConstraintSystem, LookupRangeChecker, challenge, blind)

    tpk = convert.proving_key_from_reference(pk, port.g1, port.g2)
    proof = port.prove_committed(tpk, build, rng=random.Random(11),
                                 r_rand=5, s_rand=9)
    g1, g2 = ref.g1, ref.g2
    ref_proof = RefCommittedProof(
        a=point_to_reference(g1, proof.a), b=point_to_reference(g2, proof.b),
        c=point_to_reference(g1, proof.c), d=point_to_reference(g1, proof.d),
        pok=point_to_reference(g1, proof.pok))
    return dict(ref=ref, port=port, vk=vk, builds=builds, proof=proof,
                ref_proof=ref_proof,
                tvk=convert.verifying_key_from_reference(vk, port.g1, port.g2))


def test_refinalize_hook_builds_once(run):
    assert run["builds"] == [0]


@pytest.mark.parametrize("public, ok", [(7, True), (8, False)])
def test_verify_committed_in_both_packages(run, public, ok):
    assert run["port"].verify_committed(run["tvk"], run["proof"], [public]) is ok
    assert run["ref"].verify_committed(run["vk"], run["ref_proof"], [public]) is ok


def test_pok_swapped_for_d_is_refused(run):
    p = run["proof"]
    bad = CommittedProof(a=p.a, b=p.b, c=p.c, d=p.d, pok=p.d)
    assert not run["port"].verify_committed(run["tvk"], bad, [7])
