"""Shared inputs of the vote-verifier (c2) tests: one witness built by the
circuits of both packages.

The inner toy "ballot proof" is the one of
tests/test_voteverifier_circuit.py:24-38 (x^2 = h, h public, r = 3,
s = 5), made by the reference on the toy BLS12 curve; its key and proof
are tests/vectors/c2_inner_toy.json (`vk_to_bytes`, `proof_to_dict`),
which test_torch_toycurve.py holds against the reference's own setup and
prove, and each package reads them with its own `vk_from_bytes` and
`proof_from_dict`.  The signer and the vote id are drawn from the same
`random.Random(97)` after the inner witness.
"""

import functools
import importlib
import json
import random
from pathlib import Path

from davinci_tpu import spec as ref_protocol
from davinci_tpu.circuits import toycurve as ref_toycurve
from davinci_tpu.circuits import voteverifier as ref_vv
from davinci_tpu.groth16.serialize import cs_structure_hash as ref_hash
from davinci_tpu_torch.circuits import toycurve
from davinci_tpu_torch.circuits import voteverifier as vv
from davinci_tpu_torch.groth16.serialize import cs_structure_hash

INNER_TOY = Path(__file__).parent / "vectors" / "c2_inner_toy.json"

# the lookup tier's challenge and blind of test_voteverifier_circuit.py:101
CHALLENGE, BLIND = 0x1CEB00DA999, 5
PROCESS_ID = 12345
# the two lite tiers of the toy c2 and the reference's builds of them
# (CHALLENGE, BLIND), which the port's must equal: the inner-proof half
# (test_torch_voteverifier.py; the reference's build made again in
# test_torch_voteverifier_ref.py) and the signature half, without the
# inner proof and hashed natively (test_torch_voteverifier_sig.py and
# test_torch_voteverifier_sig_ref.py)
NOSIG_TIER = {"use_lookup": True, "include_signature": False}
NOSIG_TIER_REFERENCE = {
    "constraints": 244036, "variables": 391331,
    "public": [0x9c5e94c330f0bff320b2f6b4fab0944360deaa19b9b8d085c2242157edd6b6],
    "structure_hash":
        "d1d187253a26a583608becca5803e3f9d3a153b5939f457cbfe117b87ce91df7"}
SIG_TIER = {"use_lookup": True, "include_inner_proof": False,
            "hash_native": True}
SIG_TIER_REFERENCE = {
    "constraints": 436938, "variables": 467102,
    "public": [0x38e6584a31bc7447cb7b6e0ff18486b23032188ffd2698a840531bc068f88],
    "structure_hash":
        "b85875c2c0ca1ff71b15661c94a670b96e49ddfa1b09d1a3425ec9d9899804fe"}


def _toy_draws():
    """The inner witness x, the signer's key and the vote id."""
    r = ref_toycurve.toy_bls12()["r"]
    rng = random.Random(97)
    x_v = rng.randrange(2, r)
    priv = rng.randrange(1, r)  # the toy g1's order is the toy r
    return x_v, priv, ref_protocol.VOTE_ID_MIN + rng.randrange(1 << 40)


@functools.cache
def toy_inner_proof(pkg):
    """The reference's key and proof (r = 3, s = 5) of h = x^2, read from
    INNER_TOY by package `pkg` ("davinci_tpu" or "davinci_tpu_torch") on
    its toy curve."""
    ser = importlib.import_module(f"{pkg}.groth16.serialize")
    t = importlib.import_module(f"{pkg}.circuits.toycurve").toy_bls12()
    vector = json.loads(INNER_TOY.read_text())
    return (ser.vk_from_bytes(bytes.fromhex(vector["vk"]), t["g1"], t["g2"]),
            ser.proof_from_dict(vector["proof"], t["g1"], t["g2"]))


def toy_inputs(**tier):
    """((params, witness) of the reference, (params, witness) of the port)
    for the toy c2 at `tier` (keyword arguments of VoteVerifierParams;
    12-byte signature coordinates, as the toy p is 85 bits).  A tier
    without the inner proof gets no inner key or proof."""
    ref_t, t = ref_toycurve.toy_bls12(), toycurve.toy_bls12()
    x_v, priv, vote_id = _toy_draws()
    ih = x_v * x_v % t["r"]
    if not tier.get("include_inner_proof", True):
        return tuple(_inputs(mod, toy, None, None, ih, priv, vote_id, tier)
                     for mod, toy in ((ref_vv, ref_t), (vv, t)))
    return (
        _inputs(ref_vv, ref_t, *toy_inner_proof("davinci_tpu"), ih, priv,
                vote_id, tier),
        _inputs(vv, t, *toy_inner_proof("davinci_tpu_torch"), ih, priv,
                vote_id, tier),
    )


def _inputs(mod, toy, inner_vk, inner_proof, ih, priv, vote_id, tier):
    params = mod.VoteVerifierParams(
        inner_ctx=toy["ctx"], inner_vk=inner_vk, sig_spec=toy["g1"],
        sig_coord_bits=96, **tier)
    w = mod.make_vote_verifier_witness(
        params, process_id=PROCESS_ID, priv_sig_key=priv, inputs_hash=ih,
        ballot_proof=inner_proof, vote_id=vote_id)
    return params, w


def fingerprint(cs, structure_hash=cs_structure_hash):
    """What two builds of one system share: its counts, public values and
    structure hash."""
    return {"constraints": len(cs.constraints),
            "variables": cs.num_variables, "public": cs.public_values(),
            "structure_hash": structure_hash(cs)}


def assert_builds_equal(ref_cs, cs):
    """The same system: counts, public values and structure hash."""
    assert len(cs.constraints) == len(ref_cs.constraints)
    assert cs.num_variables == ref_cs.num_variables
    assert cs.num_public == ref_cs.num_public == 1
    assert cs.public_values() == ref_cs.public_values()
    assert cs_structure_hash(cs) == ref_hash(ref_cs)


def build_both(tier, challenge=CHALLENGE, blind=BLIND):
    """The toy c2 at `tier` built by both packages; returns (reference
    system, port system, port witness)."""
    ref_cs, ref_w = build_one("davinci_tpu", tier, challenge, blind)
    cs, w = build_one("davinci_tpu_torch", tier, challenge, blind)
    return ref_cs, cs, w


def build_one(pkg, tier, challenge=CHALLENGE, blind=BLIND):
    """The toy c2 at `tier` built by package `pkg` alone, from the
    witness that both packages make (which must agree); returns (the
    system, its witness)."""
    (ref_params, ref_w), (params, w) = toy_inputs(**tier)
    assert (w.address, w.sig_r, w.sig_s) == (ref_w.address, ref_w.sig_r,
                                             ref_w.sig_s)
    mod, params, w = ((ref_vv, ref_params, ref_w) if pkg == "davinci_tpu"
                      else (vv, params, w))
    return mod.build_vote_verifier_circuit(params, w, challenge, blind), w
