"""CSP (credential service provider): EdDSA-BabyJubJub certificate census.

Role parity: reference crypto/csp/ (csp.go CSP interface; eddsa/
babyjubjub_eddsa.go sign(voterIndex, processID, address, weight) with
Poseidon challenge; census root = Poseidon(pubkey)).

Key and nonce derivation follow iden3's babyjub.PrivateKey exactly:
scalar = prune(Blake512(k)[:32]) >> 3 over B8, nonce r =
Blake512(Blake512(k)[32:] || msg_le32) mod L (hash/blake512.py — the
ORIGINAL Blake-512, which go-iden3-crypto vendors), and the Poseidon-5
challenge matches babyjub.SignPoseidon verification (S*B8 == R8 + c*A,
c = Poseidon(R8.x, R8.y, A.x, A.y, msg)).  Key-for-key parity is vector-
tested in tests/test_csp_dkg.py against the iden3 babyjub test key.

Points are kept in TE (iden3) coordinates here because iden3's EdDSA is
defined on them; conversion helpers bridge to the RTE protocol layer.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.curves import babyjubjub as te
from davinci_tpu_torch.hash import poseidon_hash

ORDER = F.BABYJUBJUB_L
# types.CensusOriginCSPEdDSABabyJubJubV1 (reference types/census.go:17-21
# iota enum — Unknown=0, three MerkleTree origins=1..3, CSP=4)
from davinci_tpu_torch.spec import CENSUS_ORIGIN_CSP_EDDSA_BJJ as CENSUS_ORIGIN_CSP_EDDSA_BJJ_V1


def _prune_scalar(h32: bytes) -> int:
    """Ed25519-style clamping as iden3 babyjub does, then >> 3."""
    b = bytearray(h32)
    b[0] &= 0xF8
    b[31] &= 0x7F
    b[31] |= 0x40
    return int.from_bytes(bytes(b), "little") >> 3


@dataclass
class EdDSASignature:
    r8: tuple  # TE point
    s: int


class BabyJubJubEdDSA:
    def __init__(self, seed: bytes, raw_key: bytes | None = None):
        """seed -> 32-byte raw private key (reference
        NewBabyJubJubKeyFromSeed hashes the seed; here SHA-256, since the
        reference's Poseidon byte-sponge cannot be vector-checked offline)
        -> iden3 babyjub key schedule via Blake-512.  Pass `raw_key` to
        use an exact 32-byte babyjub private key (iden3 interop)."""
        from davinci_tpu_torch.hash.blake512 import blake512

        if raw_key is None:
            assert seed, "seed cannot be empty"
            raw_key = hashlib.sha256(seed).digest()
        assert len(raw_key) == 32
        self._key = blake512(raw_key)
        self.scalar = _prune_scalar(self._key[:32])
        self.public = te.mul(te.base8, self.scalar)

    def census_root(self) -> int:
        return poseidon_hash([self.public[0], self.public[1]])

    def sign(self, msg: int) -> EdDSASignature:
        """Deterministic nonce per iden3 babyjub.SignPoseidon: r =
        Blake512(h[32:] || msg_le32) mod L."""
        from davinci_tpu_torch.hash.blake512 import blake512

        msg %= F.BN254_R
        r_src = blake512(self._key[32:] + msg.to_bytes(32, "little"))
        r = int.from_bytes(r_src, "little") % ORDER
        r8 = te.mul(te.base8, r)
        c = poseidon_hash([r8[0], r8[1], self.public[0], self.public[1], msg])
        s = (r + c * self.scalar) % ORDER
        return EdDSASignature(r8, s)

    @staticmethod
    def verify(public: tuple, msg: int, sig: EdDSASignature) -> bool:
        msg %= F.BN254_R
        c = poseidon_hash(
            [sig.r8[0], sig.r8[1], public[0], public[1], msg]
        )
        lhs = te.mul(te.base8, sig.s)
        rhs = te.add(sig.r8, te.mul(public, c))
        return lhs == rhs

    # -- census proof surface (reference csp.go GenerateProof/VerifyProof) ---

    def generate_proof(
        self, process_id: int, address: int, weight: int, voter_index: int = 0
    ) -> dict:
        msg = csp_message(voter_index, process_id, address, weight)
        sig = self.sign(msg)
        return {
            "census_origin": CENSUS_ORIGIN_CSP_EDDSA_BJJ_V1,
            "root": self.census_root(),
            "public_key": self.public,
            "address": address,
            "process_id": process_id,
            "weight": weight,
            "voter_index": voter_index,
            "signature": sig,
        }

    @staticmethod
    def verify_proof(proof: dict) -> bool:
        pub = proof["public_key"]
        if poseidon_hash([pub[0], pub[1]]) != proof["root"]:
            return False
        msg = csp_message(
            proof["voter_index"],
            proof["process_id"],
            proof["address"],
            proof["weight"],
        )
        return BabyJubJubEdDSA.verify(pub, msg, proof["signature"])


def csp_circuit_proof(proof: dict) -> dict:
    """Wire CSP proof -> the circuit-witness dict shape consumed by
    circuits/statetransition (census_proofs[i], kind == "csp").  Accepts
    the signature as an EdDSASignature or its JSON wire dict."""
    sig = proof["signature"]
    if isinstance(sig, dict):
        r8, s = (int(sig["r8x"]), int(sig["r8y"])), int(sig["s"])
    else:
        r8, s = tuple(sig.r8), sig.s
    return {
        "kind": "csp",
        "public": tuple(proof["public_key"]),
        "r8": r8,
        "s": s,
        "voter_index": proof["voter_index"],
    }


def csp_message(voter_index: int, process_id: int, address: int, weight: int) -> int:
    """Poseidon binding of (voterIndex, processID, address, weight)
    (reference eddsa signatureMessage)."""
    return poseidon_hash([voter_index, process_id, address, weight])
