"""Exponential ElGamal over BabyJubJub (RTE coords) + ballots + decryption
proofs + BSGS discrete-log recovery.

Role parity: reference crypto/elgamal/ (elgamal.go:16-109 Encrypt/Decrypt,
ballot.go:27-255 Ballot with Poseidon-chained per-field randomness,
proof.go Chaum-Pedersen decryption proofs with MultiPoseidon Fiat-Shamir).
"""

from __future__ import annotations

import math
import random as _random
from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.elgamal.bjj import BJJ, GENERATOR, IDENTITY, ORDER
from davinci_tpu_torch.hash import multi_poseidon, poseidon_hash
from davinci_tpu_torch.spec import FIELDS_PER_BALLOT


def random_k(rng=None) -> int:
    """Randomness in the BN254 scalar field (reference spec/util RandomK)."""
    rng = rng or _random
    return rng.randrange(F.BN254_R)


def generate_key(rng=None):
    rng = rng or _random
    d = rng.randrange(1, ORDER)
    return GENERATOR.mul(d), d


def encrypt_with_k(pub: BJJ, msg: int, k: int):
    """(C1, C2) = (k*G, m*G + k*P) — reference elgamal.go:29-48."""
    m = msg % ORDER
    c1 = GENERATOR.mul(k)
    s = pub.mul(k)
    c2 = GENERATOR.mul(m).add(s)
    return c1, c2


def encrypted_zero(pub: BJJ, k: int):
    return GENERATOR.mul(k), pub.mul(k)


def decrypt_point(priv: int, c1: BJJ, c2: BJJ) -> BJJ:
    """M = C2 - d*C1."""
    return c2.add(c1.mul(priv).neg())


def baby_step_giant_step(M: BJJ, max_message: int) -> int | None:
    """Find m <= max_message with m*G == M (reference elgamal.go Decrypt,
    bound <= 10^12 per sequencer/finalizer.go:22-30)."""
    if M.is_identity():
        return 0
    n = math.isqrt(max_message) + 1
    table = {}
    cur = IDENTITY
    for j in range(n):
        table[cur.coords()] = j
        cur = cur.add(GENERATOR)
    # giant steps: M - i*n*G
    step = GENERATOR.mul(n).neg()
    cur = M
    for i in range(n + 1):
        j = table.get(cur.coords())
        if j is not None:
            m = i * n + j
            if m <= max_message:
                return m
        cur = cur.add(step)
    return None


def decrypt(pub: BJJ, priv: int, c1: BJJ, c2: BJJ, max_message: int):
    M = decrypt_point(priv, c1, c2)
    m = baby_step_giant_step(M, max_message)
    if m is None:
        raise ValueError("message out of range")
    return M, m


# ---------------------------------------------------------------------------
# Ballots (8 ciphertexts, Poseidon-chained randomness)
# ---------------------------------------------------------------------------


@dataclass
class Ballot:
    """8 ElGamal ciphertexts; randomness for field i is the i+1-fold
    Poseidon chain of the master k (reference ballot.go:63-90)."""

    ciphertexts: list  # [(C1, C2)] * 8

    @classmethod
    def zero(cls) -> "Ballot":
        return cls([(IDENTITY, IDENTITY) for _ in range(FIELDS_PER_BALLOT)])

    @classmethod
    def encrypt(cls, messages: list[int], pub: BJJ, k: int) -> "Ballot":
        assert len(messages) == FIELDS_PER_BALLOT
        last_k = poseidon_hash([k])
        cts = []
        for m in messages:
            cts.append(encrypt_with_k(pub, m, last_k))
            last_k = poseidon_hash([last_k])
        return cls(cts)

    @classmethod
    def encrypted_zero(cls, pub: BJJ, k: int) -> "Ballot":
        last_k = k
        cts = []
        for _ in range(FIELDS_PER_BALLOT):
            cts.append(encrypted_zero(pub, last_k))
            last_k = poseidon_hash([last_k])
        return cls(cts)

    def add(self, other: "Ballot") -> "Ballot":
        return Ballot(
            [
                (a1.add(b1), a2.add(b2))
                for (a1, a2), (b1, b2) in zip(self.ciphertexts, other.ciphertexts)
            ]
        )

    def reencrypt(self, pub: BJJ, k: int):
        """Add an encryption of zero with chained k' = Poseidon(k)
        (reference ballot.go:92-114)."""
        k2 = poseidon_hash([k])
        return self.add(Ballot.encrypted_zero(pub, k2)), k2

    def coords(self) -> list[int]:
        """Flatten to 32 RTE field values (C1.x, C1.y, C2.x, C2.y) * 8."""
        out = []
        for c1, c2 in self.ciphertexts:
            out += [c1.x, c1.y, c2.x, c2.y]
        return out

    def hash(self) -> int:
        """MultiPoseidon over the 32 coordinates (ballot hash)."""
        return multi_poseidon(self.coords())

    def is_zero(self) -> bool:
        return all(
            c1.is_identity() and c2.is_identity() for c1, c2 in self.ciphertexts
        )


# ---------------------------------------------------------------------------
# Chaum-Pedersen decryption proofs
# ---------------------------------------------------------------------------


@dataclass
class DecryptionProof:
    a1: BJJ
    a2: BJJ
    z: int


def _challenge(pub: BJJ, c1: BJJ, d_pt: BJJ, a1: BJJ, a2: BJJ) -> int:
    """e = MultiPoseidon(P, P, C1, D, A1, A2) over RTE coords
    (reference proof.go:120-127 — publicKey passed twice)."""
    pts = [pub, pub, c1, d_pt, a1, a2]
    vals = []
    for p in pts:
        vals += [p.x, p.y]
    return multi_poseidon(vals)


def build_decryption_proof(
    priv: int, pub: BJJ, c1: BJJ, c2: BJJ, msg: int, rng=None
) -> DecryptionProof:
    rng = rng or _random
    r = rng.randrange(1, ORDER)
    a1 = GENERATOR.mul(r)
    a2 = c1.mul(r)
    d_pt = c2.add(GENERATOR.mul(msg % ORDER).neg())
    e = _challenge(pub, c1, d_pt, a1, a2)
    z = (r + e * priv) % ORDER
    return DecryptionProof(a1, a2, z)


def verify_decryption_proof(
    pub: BJJ, c1: BJJ, c2: BJJ, msg: int, proof: DecryptionProof
) -> bool:
    d_pt = c2.add(GENERATOR.mul(msg % ORDER).neg())
    e = _challenge(pub, c1, d_pt, proof.a1, proof.a2)
    lhs1 = GENERATOR.mul(proof.z)
    rhs1 = proof.a1.add(pub.mul(e))
    lhs2 = c1.mul(proof.z)
    rhs2 = proof.a2.add(d_pt.mul(e))
    return lhs1 == rhs1 and lhs2 == rhs2
