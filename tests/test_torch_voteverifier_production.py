"""The production vote verifier (c2: BN254 inner pairing, secp256k1,
keccak, the lookup tier) from the c1 proof and verifying key that
`chip_smoke.py` phase 5 made on the card (tests/vectors/c2_inner_bn254.json):
its witness in both packages against each other and the card's.  Behind
RUN_SLOW_TESTS, the full-size c2 built from that vector by both packages,
one after the other, so that one build's memory is free before the next.
"""

import gc
import json
import os
from pathlib import Path

import pytest
import torch

from davinci_tpu_torch.circuits import voteverifier as vv

torch.set_num_threads(1)

VECTOR = Path(__file__).parent / "vectors" / "c2_inner_bn254.json"


def _production_inputs(pkg, vector):
    """c2's production parameters and witness in package `pkg` (the
    reference or the port) from the vector's c1 key and proof."""
    import importlib

    C = importlib.import_module(f"{pkg}.curves")
    ser = importlib.import_module(f"{pkg}.groth16.serialize")
    mod = importlib.import_module(f"{pkg}.circuits.voteverifier")
    sign = importlib.import_module(f"{pkg}.ethereum").sign
    bn254_pairing = importlib.import_module(f"{pkg}.pairing").bn254_pairing
    vk = ser.vk_from_bytes(bytes.fromhex(vector["vk"]), C.bn254_g1, C.bn254_g2)
    proof = ser.proof_from_dict(vector["proof"], C.bn254_g1, C.bn254_g2)
    params = mod.VoteVerifierParams(inner_ctx=bn254_pairing, inner_vk=vk,
                                    sig_spec=C.secp256k1, use_lookup=True)

    def eth_sign(d, e):
        r, s, _ = sign(d, e.to_bytes(32, "big"))
        return r, s

    w = mod.make_vote_verifier_witness(
        params, process_id=vector["process_id"],
        priv_sig_key=vector["priv_sig_key"],
        inputs_hash=vector["inputs_hash"], ballot_proof=proof,
        vote_id=vector["vote_id"], sign_fn=eth_sign)
    return mod, params, w


def test_production_witness_from_the_card_equals_the_reference():
    """The card's c1 proof verifies under its key in both packages, and
    the production c2's witness from it (secp256k1 signed by
    `ethereum.sign`) is the reference's, with the address and the public
    vote hash that phase 10 printed on the card."""
    vector = json.loads(VECTOR.read_text())
    (ref_mod, ref_params, ref_w), (mod, params, w) = (
        _production_inputs(pkg, vector)
        for pkg in ("davinci_tpu", "davinci_tpu_torch"))
    for name in ("address", "inputs_hash", "vote_id", "sig_r", "sig_s"):
        assert getattr(w, name) == getattr(ref_w, name)
    assert (w.pubkey.x.v, w.pubkey.y.v) == (ref_w.pubkey.x.v,
                                            ref_w.pubkey.y.v)
    card = vector["c2_on_the_card"]
    assert w.address == int(card["address"], 16)
    vote_hash = vv.witness_vote_hash(params, w)
    assert vote_hash == ref_mod.witness_vote_hash(ref_params, ref_w)
    assert vote_hash == int(card["vote_hash"], 16)
    from davinci_tpu.groth16 import Groth16 as RefGroth16
    from davinci_tpu_torch.groth16 import Groth16

    public = [vector["inputs_hash"]]
    assert Groth16("bn254", device="cpu").verify(
        params.inner_vk, w.ballot_proof, public)
    assert RefGroth16("bn254").verify(ref_params.inner_vk, ref_w.ballot_proof,
                                      public)


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="two full-size c2 builds of 3.4M constraints; set RUN_SLOW_TESTS=1")
def test_production_c2_from_the_card_equals_the_reference():
    """The full-size c2 (BN254 inner pairing, secp256k1, keccak, the lookup
    tier) from the c1 proof and key that `chip_smoke.py` phase 5 made on
    the card, built by both packages as phase 10 builds it (challenge 0,
    blind 1), and equal to the card's own build."""
    from davinci_tpu.groth16.serialize import cs_structure_hash as ref_hash
    from torch_c2_cases import fingerprint

    vector = json.loads(VECTOR.read_text())
    ref_mod, ref_params, ref_w = _production_inputs("davinci_tpu", vector)
    want = fingerprint(
        ref_mod.build_vote_verifier_circuit(ref_params, ref_w, 0, 1),
        ref_hash)
    gc.collect()
    mod, params, w = _production_inputs("davinci_tpu_torch", vector)
    got = fingerprint(mod.build_vote_verifier_circuit(params, w, 0, 1))
    assert got == want
    card = vector["c2_on_the_card"]
    assert (got["constraints"], got["variables"], got["structure_hash"]) == (
        card["constraints"], card["variables"], card["structure_hash"])
