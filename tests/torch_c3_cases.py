"""Shared inputs of the aggregator (c3) tests: a committed BLS12-377 key
and proof made by the reference, and the aggregator built from them.

The inner circuit stands in for the vote verifier (c2) at the shape the
aggregator sees: one public input (the "vote hash", 7) and the commitment
extension of the lookup tier (a chain of two emulated products modulo
13, range-checked by a 4-entry lookup: the circuit of
tests/test_torch_committed_bls12.py).  The reference's key (setup from
`random.Random(SETUP_SEED)`) and committed proof (`random.Random(11)`,
r = 5, s = 9) are tests/vectors/c3_inner_bls12_377.json (`pk_to_bytes`,
`vk_to_bytes`, `proof_to_dict`); `python tests/torch_c3_cases.py`, from
the repository root, makes them again.  test_torch_committed_bls12.py
proves the same circuit with the port from that key.  Each package reads them with its own
`vk_from_bytes` and `proof_from_dict`.

The aggregator is the production shape (`inner_committed=True`, BW6-761,
31-byte batch hash) at one slot, the real vote in it: `AGG_REFERENCE` is
the reference's build of it, which the port's must equal.
"""

import functools
import importlib
import json
import random
from pathlib import Path

VECTOR = Path(__file__).parent / "vectors" / "c3_inner_bls12_377.json"
SETUP_SEED = 0xC3
VOTE_HASH = 7
SLOTS = 1
# the reference's build of the one-slot aggregator from the vector
AGG_REFERENCE = {
    "constraints": 244970, "variables": 244973,
    "public": [
        0x2341f1a4af720c5cc9c7368790bda29ade34e70cb232d3428ea38e8536f2ce],
    "structure_hash":
        "a8fc44034c3b5f4a725548adbbf6717832e4a5835171e91fe9f82702877b640a"}

EMU_P, LIMB_BITS, N_LIMBS = 13, 2, 2
A, B, CHAIN = 11, 6, 2


def inner_circuit(pkg, challenge, blind):
    """The committed BLS12-377 stand-in, built by package `pkg`."""
    F = importlib.import_module(f"{pkg}.fields")
    r1cs = importlib.import_module(f"{pkg}.groth16.r1cs")
    lookup = importlib.import_module(f"{pkg}.circuits.lookup")
    emulated = importlib.import_module(f"{pkg}.circuits.emulated")
    cs = r1cs.ConstraintSystem(F.BLS12_377_R)
    marker = cs.pub_input(VOTE_HASH)
    rc = lookup.LookupRangeChecker(cs, table_bits=2)
    E = emulated.EmulatedOps(cs, EMU_P, LIMB_BITS, N_LIMBS, range_checker=rc)
    acc, b = E.alloc(A), E.alloc(B)
    for _ in range(CHAIN):
        acc = E.mul(acc, b)
    E.assert_eq(acc, E.constant(A * pow(B, CHAIN, EMU_P) % EMU_P))
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(VOTE_HASH))
    return cs


@functools.cache
def inner_key_and_proof(pkg):
    """The reference's verifying key and committed proof, read from
    VECTOR by package `pkg` on BLS12-377."""
    ser = importlib.import_module(f"{pkg}.groth16.serialize")
    C = importlib.import_module(f"{pkg}.curves")
    vector = json.loads(VECTOR.read_text())
    return (ser.vk_from_bytes(bytes.fromhex(vector["vk"]), C.bls377_g1,
                              C.bls377_g2),
            ser.proof_from_dict(vector["proof"], C.bls377_g1, C.bls377_g2))


def aggregator_inputs(pkg, n_votes=SLOTS, vote_hash=VOTE_HASH):
    """(params, witness) of package `pkg`'s aggregator: the vector's proof
    as the real vote and as the dummy that pads the other slots."""
    agg = importlib.import_module(f"{pkg}.circuits.aggregator")
    vk, proof = inner_key_and_proof(pkg)
    params = agg.AggregatorParams(inner_vk=vk, dummy_proof=proof,
                                  dummy_public=VOTE_HASH, n_votes=n_votes,
                                  inner_committed=True)
    return params, agg.AggregatorWitness(vote_hashes=[vote_hash],
                                         proofs=[proof])


def build(pkg, **kw):
    """Package `pkg`'s aggregator build from the vector."""
    agg = importlib.import_module(f"{pkg}.circuits.aggregator")
    return agg.build_aggregator_circuit(*aggregator_inputs(pkg, **kw))


def fingerprint(pkg, cs):
    """Counts, public values and structure hash of a build."""
    ser = importlib.import_module(f"{pkg}.groth16.serialize")
    return {"constraints": len(cs.constraints),
            "variables": cs.num_variables, "public": cs.public_values(),
            "structure_hash": ser.cs_structure_hash(cs)}


def make_vector():
    """The reference's key and committed proof of the stand-in."""
    from davinci_tpu.groth16 import Groth16
    from davinci_tpu.groth16.serialize import (pk_to_bytes, proof_to_dict,
                                               vk_to_bytes)

    g16 = Groth16("bls12_377")
    pk, vk = g16.setup(inner_circuit("davinci_tpu", 0, 0),
                       rng=random.Random(SETUP_SEED))
    proof = g16.prove_committed(
        pk, lambda ch, bl: inner_circuit("davinci_tpu", ch, bl),
        rng=random.Random(11), r_rand=5, s_rand=9)
    assert g16.verify_committed(vk, proof, [VOTE_HASH])
    return {"vote_hash": VOTE_HASH,
            "pk": pk_to_bytes(pk, g16.g1, g16.g2).hex(),
            "vk": vk_to_bytes(vk, g16.g1, g16.g2).hex(),
            "proof": proof_to_dict(proof)}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    VECTOR.write_text(json.dumps(make_vector(), indent=1) + "\n")
