"""Results-verifier circuit (circuit 5): proves correct decryption of the 8
accumulated result ciphertexts against the state root.

Role parity: reference circuits/results/results.go (BN254): results +
encryption-key Merkle proofs against StateRoot, leaf-hash binding,
Chaum-Pedersen decryption proof per field, range constraints.  Our version
omits gnark's forceCommitment (Pedersen commitment extension) — soundness
of the range/bit gadgets here rests on canonical decompositions instead.

Parametrized by (n_levels, n_fields) so reduced instances keep CI fast;
production uses spec values (64, 8), mirroring the reference's gated
circuit-test pattern (RUN_CIRCUIT_TESTS).
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch import spec
from davinci_tpu_torch.circuits import gadgets as G
from davinci_tpu_torch.elgamal import Ballot, build_decryption_proof
from davinci_tpu_torch.elgamal.bjj import ORDER
from davinci_tpu_torch.groth16.r1cs import ConstraintSystem
from davinci_tpu_torch.state.smt import SMTProof


@dataclass
class ResultsWitness:
    state_root: int
    results: list[int]                  # plaintext results (public)
    encrypted_results: Ballot
    results_proof: SMTProof
    enc_key_proof: SMTProof
    pubkey: tuple                       # (x, y) RTE
    decryption_proofs: list             # DecryptionProof per field


def build_results_circuit(
    w: ResultsWitness,
    n_levels: int = spec.STATE_TREE_MAX_LEVELS,
    n_fields: int = spec.FIELDS_PER_BALLOT,
) -> ConstraintSystem:
    cs = ConstraintSystem(F.BN254_R)

    # -- public inputs (order defines the vk layout) -------------------------
    state_root = cs.pub_input(w.state_root)
    results = [cs.pub_input(w.results[i]) for i in range(n_fields)]

    # -- private witness -----------------------------------------------------
    coords = w.encrypted_results.coords()[: n_fields * 4]
    enc = [cs.priv_input(v) for v in coords]
    pk = (cs.priv_input(w.pubkey[0]), cs.priv_input(w.pubkey[1]))

    res_sib = [cs.priv_input(s) for s in w.results_proof.padded_siblings(n_levels)]
    key_sib = [cs.priv_input(s) for s in w.enc_key_proof.padded_siblings(n_levels)]

    dps = []
    for i in range(n_fields):
        p = w.decryption_proofs[i]
        dps.append(
            (
                (cs.priv_input(p.a1.x), cs.priv_input(p.a1.y)),
                (cs.priv_input(p.a2.x), cs.priv_input(p.a2.y)),
                cs.priv_input(p.z),
            )
        )

    # -- merkle proofs -------------------------------------------------------
    results_value = G.smt_encode_leaf_value(cs, enc)
    results_leaf = G.smt_leaf_hash(
        cs, cs.constant(spec.STATE_KEY_RESULTS), results_value
    )
    G.smt_verify_inclusion(
        cs, state_root, res_sib, cs.constant(spec.STATE_KEY_RESULTS),
        results_leaf, n_levels,
    )

    key_value = G.smt_encode_leaf_value(cs, [pk[0], pk[1]])
    key_leaf = G.smt_leaf_hash(
        cs, cs.constant(spec.STATE_KEY_ENCRYPTION_KEY), key_value
    )
    G.smt_verify_inclusion(
        cs, state_root, key_sib, cs.constant(spec.STATE_KEY_ENCRYPTION_KEY),
        key_leaf, n_levels,
    )

    # -- decryption proofs ---------------------------------------------------
    for i in range(n_fields):
        c1 = (enc[4 * i], enc[4 * i + 1])
        c2 = (enc[4 * i + 2], enc[4 * i + 3])
        a1, a2, z = dps[i]
        G.verify_decryption_proof_gadget(
            cs, pk, c1, c2, results[i], a1, a2, z
        )

    # -- range: results < bjj subgroup order ---------------------------------
    for i in range(n_fields):
        bits = cs.to_bits(results[i], ORDER.bit_length())
        G.assert_bits_lt_const(cs, bits, ORDER)

    return cs


def results_witness_from_state(state, priv: int, max_message: int, rng=None):
    """Finalizer-side witness builder: decrypt accumulators + build proofs
    (reference sequencer/finalizer.go:266-451 finalize)."""
    from davinci_tpu_torch.elgamal import decrypt
    from davinci_tpu_torch.elgamal.bjj import BJJ

    pub = BJJ(*state.encryption_key())
    enc_results = state.results()
    results = []
    dproofs = []
    for c1, c2 in enc_results.ciphertexts:
        _, m = decrypt(pub, priv, c1, c2, max_message)
        results.append(m)
        dproofs.append(build_decryption_proof(priv, pub, c1, c2, m, rng))
    return ResultsWitness(
        state_root=state.root,
        results=results,
        encrypted_results=enc_results,
        results_proof=state.tree.prove(spec.STATE_KEY_RESULTS),
        enc_key_proof=state.tree.prove(spec.STATE_KEY_ENCRYPTION_KEY),
        pubkey=(pub.x, pub.y),
        decryption_proofs=dproofs,
    )
