"""The vote verifier (c2, `circuits/voteverifier.py` and its gadgets,
verbatim copies) built by the port and by the JAX package from one
witness (tests/torch_c2_cases.py).

Tier 1 runs the toy c2's lite tier without the signature: the emulated
inner Groth16 verification, the emulated BN254 Poseidon vote hash and
the lookup range checks (244,036 constraints).  The port's build must
have the counts, public value and structure hash of the reference's,
`NOSIG_TIER_REFERENCE`, which test_torch_voteverifier_ref.py makes again
from the reference (the two builds run in two files to keep each under
half a minute).  The signature half is in test_torch_voteverifier_sig.py,
the production c2 in test_torch_voteverifier_production.py.  Behind RUN_SLOW_TESTS: the whole
lookup tier (671,834 constraints) and the bit-decomposition tier in the
port (satisfiable, unsatisfiable when tampered, as
tests/test_voteverifier_circuit.py:60-109).
"""

import os

import pytest
import torch
from torch_c2_cases import (
    BLIND,
    CHALLENGE,
    NOSIG_TIER,
    NOSIG_TIER_REFERENCE,
    assert_builds_equal,
    build_both,
    build_one,
    fingerprint,
)

from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.circuits import voteverifier as vv

torch.set_num_threads(1)

slow = pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="builds of millions of constraints; set RUN_SLOW_TESTS=1")


def test_lite_c2_without_signature_equals_the_reference():
    cs, w = build_one("davinci_tpu_torch", NOSIG_TIER)
    assert fingerprint(cs) == NOSIG_TIER_REFERENCE
    assert cs.public_values() == [w.vote_hash(TF.BN254_R)]
    assert cs.check_satisfied(), cs.first_unsatisfied()


@slow
def test_lookup_c2_equals_the_reference():
    ref_cs, cs, _ = build_both({"use_lookup": True})
    assert_builds_equal(ref_cs, cs)
    assert len(cs.constraints) == 671834
    assert cs.check_satisfied(), cs.first_unsatisfied()


@pytest.fixture(scope="module")
def bits_c2():
    """The bit-decomposition toy c2 of the port (the reference's test
    fixture, tests/test_voteverifier_circuit.py:24-57)."""
    from torch_c2_cases import toy_inputs

    _, (params, w) = toy_inputs()
    return params, w, vv.build_vote_verifier_circuit(params, w)


@slow
def test_bits_c2_satisfiable_and_tamper_address_unsat(bits_c2):
    params, w, cs = bits_c2
    assert cs.num_public == 1
    assert cs.public_values() == [w.vote_hash(params.hash_p)]
    assert cs.check_satisfied()
    idx = cs.values.index(w.address, 1)
    cs.values[idx] = (w.address + 1) % cs.p
    assert not cs.check_satisfied()
    cs.values[idx] = w.address
    assert cs.check_satisfied()


@slow
def test_bits_c2_wrong_signer_unsat(bits_c2):
    import random

    from davinci_tpu_torch.circuits.toycurve import toy_bls12

    params, w, cs = bits_c2
    other = random.Random(101).randrange(1, toy_bls12()["g1"].r)
    w2 = vv.make_vote_verifier_witness(
        params, process_id=w.process_id, priv_sig_key=other,
        inputs_hash=w.inputs_hash, ballot_proof=w.ballot_proof,
        vote_id=w.vote_id)
    w2.address = w.address  # claim the original address
    assert not vv.build_vote_verifier_circuit(params, w2).check_satisfied()


@slow
def test_lookup_tier_collapses_the_bits_tier(bits_c2):
    from dataclasses import replace

    params, w, cs_bits = bits_c2
    cs = vv.build_vote_verifier_circuit(replace(params, use_lookup=True), w,
                                        CHALLENGE, BLIND)
    assert cs.check_satisfied(), cs.first_unsatisfied()
    assert len(cs.constraints) < 0.55 * len(cs_bits.constraints)
