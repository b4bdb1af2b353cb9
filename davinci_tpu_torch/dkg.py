"""Distributed key generation (Pedersen/Feldman) + threshold decryption for
the election encryption key, over BabyJubJub.

Role parity: reference crypto/elgamal/dkg/dkg.go:12-139 (secret polynomial,
Feldman commitments, share verification, aggregation) and decrypt.go
(partial decryptions combined with Lagrange coefficients).
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field

from davinci_tpu_torch.elgamal.bjj import BJJ, GENERATOR, IDENTITY, ORDER


@dataclass
class Participant:
    id: int
    threshold: int
    participants: list
    secret_coeffs: list = field(default_factory=list)
    public_coeffs: list = field(default_factory=list)
    shares_out: dict = field(default_factory=dict)
    shares_in: dict = field(default_factory=dict)
    private_share: int = 0
    public_key: BJJ = None

    def generate_polynomial(self, rng=None):
        rng = rng or _random
        self.secret_coeffs = [
            rng.randrange(ORDER) for _ in range(self.threshold)
        ]
        self.public_coeffs = [GENERATOR.mul(c) for c in self.secret_coeffs]

    def compute_shares(self):
        for pid in self.participants:
            self.shares_out[pid] = self._eval_poly(pid)

    def _eval_poly(self, x: int) -> int:
        acc, xp = 0, 1
        for c in self.secret_coeffs:
            acc = (acc + c * xp) % ORDER
            xp = xp * x % ORDER
        return acc

    def receive_share(self, from_id: int, share: int, public_coeffs: list):
        if not verify_share(self.id, share, public_coeffs):
            raise ValueError(f"invalid share from participant {from_id}")
        self.shares_in[from_id] = share

    def aggregate_shares(self):
        self.private_share = self.shares_out[self.id]
        for share in self.shares_in.values():
            self.private_share = (self.private_share + share) % ORDER

    def aggregate_public_key(self, all_public_coeffs: dict):
        pk = IDENTITY
        for coeffs in all_public_coeffs.values():
            pk = pk.add(coeffs[0])
        self.public_key = pk


def verify_share(x: int, share: int, public_coeffs: list) -> bool:
    """share*G == sum_i commitments[i] * x^i (Feldman check)."""
    lhs = GENERATOR.mul(share)
    rhs = IDENTITY
    xp = 1
    for c in public_coeffs:
        rhs = rhs.add(c.mul(xp))
        xp = xp * x % ORDER
    return lhs == rhs


def run_dkg(ids: list, threshold: int, rng=None) -> tuple:
    """Full ceremony; returns ({id: Participant}, public_key)."""
    parts = {i: Participant(i, threshold, list(ids)) for i in ids}
    for p in parts.values():
        p.generate_polynomial(rng)
        p.compute_shares()
    for p in parts.values():
        for q in parts.values():
            if p.id != q.id:
                p.receive_share(q.id, q.shares_out[p.id], q.public_coeffs)
    all_coeffs = {i: parts[i].public_coeffs for i in ids}
    for p in parts.values():
        p.aggregate_shares()
        p.aggregate_public_key(all_coeffs)
    pk = parts[ids[0]].public_key
    assert all(p.public_key == pk for p in parts.values())
    return parts, pk


# ---------------------------------------------------------------------------
# Threshold decryption
# ---------------------------------------------------------------------------


def partial_decrypt(private_share: int, c1: BJJ) -> BJJ:
    return c1.mul(private_share)


def lagrange_coeff(i: int, subset: list) -> int:
    """Lagrange basis at x=0 over the participant-id subset."""
    num, den = 1, 1
    for j in subset:
        if j == i:
            continue
        num = num * (-j) % ORDER
        den = den * (i - j) % ORDER
    return num * pow(den, -1, ORDER) % ORDER


def combine_partials(partials: dict, c2: BJJ) -> BJJ:
    """M = C2 - sum_i lambda_i * (d_i * C1) over a threshold subset."""
    subset = sorted(partials.keys())
    acc = IDENTITY
    for i in subset:
        acc = acc.add(partials[i].mul(lagrange_coeff(i, subset)))
    return c2.add(acc.neg())


# ---------------------------------------------------------------------------
# SECIES: scalar encryption for DKG share transport
# ---------------------------------------------------------------------------
#
# Role parity: reference crypto/elgamal/dkg/secies/secies.go:13-148 —
# participants encrypt their polynomial shares to each recipient's public
# key so the dealing round can run over an untrusted channel.  Scheme
# (ECIES-shaped, self-contained primitives): ephemeral ECDH on BabyJubJub,
# Poseidon-based KDF/stream, Poseidon MAC.


@dataclass
class SECIESCiphertext:
    ephemeral: tuple   # (x, y) of r*G
    payload: int       # share + KDF stream (mod ORDER)
    mac: int


def _secies_kdf(shared: BJJ, tag: int) -> int:
    from davinci_tpu_torch.hash import poseidon_hash

    return poseidon_hash([shared.x, shared.y, tag])


def secies_keygen(rng=None) -> tuple:
    rng = rng or _random
    priv = rng.randrange(1, ORDER)
    pub = GENERATOR.mul(priv)
    return priv, pub


def secies_encrypt(recipient_pub: BJJ, share: int, rng=None) -> SECIESCiphertext:
    rng = rng or _random
    r = rng.randrange(1, ORDER)
    R = GENERATOR.mul(r)
    shared = recipient_pub.mul(r)
    stream = _secies_kdf(shared, 1) % ORDER
    payload = (share + stream) % ORDER
    mac = _secies_kdf(shared, 2 + payload)
    return SECIESCiphertext((R.x, R.y), payload, mac)


def secies_decrypt(priv: int, ct: SECIESCiphertext) -> int:
    R = BJJ(*ct.ephemeral)
    shared = R.mul(priv)
    if _secies_kdf(shared, 2 + ct.payload) != ct.mac:
        raise ValueError("SECIES: MAC verification failed")
    stream = _secies_kdf(shared, 1) % ORDER
    return (ct.payload - stream) % ORDER
