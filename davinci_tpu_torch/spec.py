"""Protocol spec: wire-level constants and canonical hashes.

Mirror of the reference's separate `spec` Go module (reference spec/params/
params.go:9-50, spec/voteid.go:10-25, spec/hash/stateroot.go, spec/hash/
voteid.go) — the normative layer both the node and the circuits build on.

Validated against the constants embedded in the reference source
(ZeroBallotHashHex / LeafResultsHex, reference spec/hash/stateroot.go:17-24).
"""

from __future__ import annotations

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.hash import multi_poseidon, poseidon_hash

# --- protocol constants (reference spec/params/params.go) -------------------

FIELDS_PER_BALLOT = 8
VOTES_PER_BATCH = 60
STATE_TREE_MAX_LEVELS = 64
VOTE_ID_LEAF_VALUE = 0

# state config keys
STATE_KEY_PROCESS_ID = 0x00
STATE_KEY_CENSUS_ORIGIN = 0x06
STATE_KEY_BALLOT_MODE = 0x02
STATE_KEY_ENCRYPTION_KEY = 0x03
STATE_KEY_RESULTS = 0x04

# census origins (reference types/census.go:17-21 iota enum)
CENSUS_ORIGIN_UNKNOWN = 0
CENSUS_ORIGIN_MERKLE_STATIC = 1     # MerkleTreeOffchainStaticV1
CENSUS_ORIGIN_MERKLE_DYNAMIC = 2    # MerkleTreeOffchainDynamicV1
CENSUS_ORIGIN_MERKLE_ONCHAIN = 3    # MerkleTreeOnchainDynamicV1
CENSUS_ORIGIN_CSP_EDDSA_BJJ = 4     # CSPEdDSABabyJubJubV1
MERKLE_CENSUS_ORIGINS = (
    CENSUS_ORIGIN_MERKLE_STATIC,
    CENSUS_ORIGIN_MERKLE_DYNAMIC,
    CENSUS_ORIGIN_MERKLE_ONCHAIN,
)

# state namespaces
CONFIG_MIN = 0
CONFIG_MAX = (1 << 4) - 1
BALLOT_MIN = CONFIG_MAX + 1
VOTE_ID_HASH_BITS = 63
VOTE_ID_MIN = (2**64 - (1 << VOTE_ID_HASH_BITS))  # 0x8000_0000_0000_0000
VOTE_ID_MAX = 2**64 - 1
BALLOT_MAX = VOTE_ID_MIN - 1
VOTER_INDEX_MAX = BALLOT_MAX - BALLOT_MIN

LEAF_DOMAIN = 1

# curves per circuit (reference spec/params/params.go:21-27)
BALLOT_PROOF_CURVE = "bn254"
VOTE_VERIFIER_CURVE = "bls12_377"
AGGREGATOR_CURVE = "bw6_761"
STATE_TRANSITION_CURVE = "bn254"
RESULTS_VERIFIER_CURVE = "bn254"


def truncate_to_lower_bits(x: int, bits: int) -> int:
    return x & ((1 << bits) - 1)


def vote_id(process_id: int, address: int, k: int) -> int:
    """Poseidon(processID, address, k) truncated to 63 bits, top bit set
    (reference spec/hash/voteid.go)."""
    for v in (process_id, address, k):
        assert 0 <= v < F.BN254_R, "inputs must be in the BN254 scalar field"
    h = poseidon_hash([process_id, address, k])
    return VOTE_ID_MIN + truncate_to_lower_bits(h, VOTE_ID_HASH_BITS)


# --- zero-ballot constants (reference spec/hash/stateroot.go:8-24) ----------


def zero_ballot_hash() -> int:
    """Poseidon multihash of 8 identity-ciphertext 4-tuples (0,1,0,1)."""
    return multi_poseidon([0, 1, 0, 1] * FIELDS_PER_BALLOT)


def leaf_results() -> int:
    return poseidon_hash([STATE_KEY_RESULTS, zero_ballot_hash(), LEAF_DOMAIN])


ZERO_BALLOT_HASH = zero_ballot_hash()
LEAF_RESULTS = leaf_results()
assert (
    hex(ZERO_BALLOT_HASH)[2:]
    == "2c66ee3d8ff0f86c2251e885d4c207e5162c05d0b458c773106cd5579c58bf36"
)
assert (
    hex(LEAF_RESULTS)[2:]
    == "1f72c52b6e5dedca4f99ecfa24f2776732431e8d544e14c6f78f5042727c4657"
)


def state_root(
    process_id: int,
    census_origin: int,
    pubkey_x: int,
    pubkey_y: int,
    ballot_mode: int,
) -> int:
    """Initial state root over the fixed config-leaf tree shape
    (reference spec/hash/stateroot.go:28-84)."""
    for v in (process_id, census_origin, pubkey_x, pubkey_y, ballot_mode):
        assert 0 <= v < F.BN254_R
    leaf_process = poseidon_hash([STATE_KEY_PROCESS_ID, process_id, LEAF_DOMAIN])
    leaf_ballot = poseidon_hash([STATE_KEY_BALLOT_MODE, ballot_mode, LEAF_DOMAIN])
    enc_key = poseidon_hash([pubkey_x, pubkey_y])
    leaf_enc_key = poseidon_hash([STATE_KEY_ENCRYPTION_KEY, enc_key, LEAF_DOMAIN])
    leaf_census = poseidon_hash([STATE_KEY_CENSUS_ORIGIN, census_origin, LEAF_DOMAIN])
    node_a0 = poseidon_hash([leaf_process, LEAF_RESULTS])
    node_a1 = poseidon_hash([leaf_ballot, leaf_census])
    node_a = poseidon_hash([node_a0, node_a1])
    return poseidon_hash([node_a, leaf_enc_key])


def ballot_inputs_hash(
    process_id: int,
    ballot_mode_packed: int,
    enc_key_x: int,
    enc_key_y: int,
    address: int,
    vote_id_value: int,
    ballot_values: list[int],
    weight: int,
) -> int:
    """Hash binding a ballot's public inputs: MultiPoseidon(processID,
    ballotModePacked, keyX, keyY, address, voteID, ballot..., weight) with
    points in RTE coordinates (reference spec/ballotinputs.go:24-62)."""
    assert ballot_values, "ballot is empty"
    inputs = [
        process_id,
        ballot_mode_packed,
        enc_key_x,
        enc_key_y,
        address,
        vote_id_value,
        *ballot_values,
        weight,
    ]
    return multi_poseidon(inputs)
