"""Host-side finite-field specs for the davinci-tpu proving stack.

This module is the *spec oracle*: every prime modulus used by the framework is
either derived from its curve-family polynomial (BLS12, BN, BW6 families) or
hardcoded and cross-checked by primality + bit-length assertions at import
time.  Device code (davinci_tpu_torch.ff) consumes the `FieldSpec` objects defined
here; host code uses plain Python ints (arbitrary precision) as the reference
implementation that device kernels are tested against.

Reference parity: the moduli match the curves used by vocdoni/davinci-node
(see reference spec/params/params.go:20-27 — BN254 for ballotproof /
statetransition / results, BLS12-377 for voteverifier, BW6-761 for the
aggregator) plus BLS12-381 for EIP-4844 KZG blob commitments
(reference crypto/blobs/) and secp256k1 for Ethereum signatures
(reference crypto/signatures/ethereum/).

Limb layout: device field elements are vectors of `num_limbs` limbs of
`LIMB_BITS` bits stored in int32, least-significant limb first.  LIMB_BITS=12
keeps every partial product (24 bits) plus an accumulation tree of up to 64
terms (6 bits) inside signed int32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Limb layout constants
# ---------------------------------------------------------------------------

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1


def _is_prime(n: int) -> bool:
    """Miller-Rabin with fixed + random bases; deterministic enough for
    import-time validation of known constants."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


# ---------------------------------------------------------------------------
# FieldSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldSpec:
    """A prime field together with its device limb layout and Montgomery
    constants.

    Attributes:
      name: short identifier, e.g. "bn254_fr".
      p: the prime modulus.
      num_limbs: number of LIMB_BITS-bit limbs used on device.  R = 2**(
        LIMB_BITS*num_limbs) is the Montgomery radix.
    """

    name: str
    p: int
    num_limbs: int

    # Derived Montgomery constants (filled in __post_init__ via object.__setattr__)
    r: int = field(init=False)          # Montgomery radix R
    r_mod_p: int = field(init=False)    # R mod p        (Montgomery form of 1)
    r2_mod_p: int = field(init=False)   # R^2 mod p      (to enter Montgomery form)
    n_prime: int = field(init=False)    # -p^{-1} mod R

    def __post_init__(self):
        assert _is_prime(self.p), f"{self.name}: modulus not prime"
        assert self.p.bit_length() <= self.num_limbs * LIMB_BITS, (
            f"{self.name}: {self.num_limbs} limbs too small for "
            f"{self.p.bit_length()}-bit modulus"
        )
        r = 1 << (LIMB_BITS * self.num_limbs)
        object.__setattr__(self, "r", r)
        object.__setattr__(self, "r_mod_p", r % self.p)
        object.__setattr__(self, "r2_mod_p", r * r % self.p)
        object.__setattr__(self, "n_prime", (-pow(self.p, -1, r)) % r)

    # -- host-side modular arithmetic (the reference implementation) --------

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def sqrt(self, a: int):
        """Tonelli-Shanks square root; returns None if a is not a QR."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r_ = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r_ = t * c % p, r_ * b % p
        return r_

    # -- limb conversion ----------------------------------------------------

    def to_limbs(self, x: int) -> np.ndarray:
        """Python int -> (num_limbs,) int32 limb vector (LSB first),
        reduced mod p."""
        return self.to_limbs_unreduced(x % self.p)

    def to_limbs_unreduced(self, x: int) -> np.ndarray:
        """Limb encoding WITHOUT mod-p reduction (for encoding p itself,
        Montgomery n', or any value < R)."""
        assert 0 <= x < (1 << (LIMB_BITS * self.num_limbs))
        out = np.empty(self.num_limbs, dtype=np.int32)
        for i in range(self.num_limbs):
            out[i] = x & LIMB_MASK
            x >>= LIMB_BITS
        return out

    def from_limbs(self, limbs) -> int:
        limbs = np.asarray(limbs)
        x = 0
        for i in reversed(range(limbs.shape[-1])):
            x = (x << LIMB_BITS) | int(limbs[..., i])
        return x % self.p

    def batch_to_limbs(self, xs) -> np.ndarray:
        """Iterable of ints -> (n, num_limbs) int32, reduced mod p.

        Bytes-vectorized: one C-level to_bytes per element plus numpy
        nibble unpacking (12-bit limbs = 3 nibbles) — the per-element
        per-limb Python loop was a dominant host cost of Groth16 proving
        (witness/NTT vectors are millions of elements at c2 scale)."""
        xs = xs if isinstance(xs, list) else list(xs)
        n = len(xs)
        L = self.num_limbs
        if n == 0:
            return np.zeros((0, L), np.int32)
        p = self.p
        Lp = L + (L & 1)  # even limb count: 3 bytes <-> 2 limbs exactly
        nb = 3 * Lp // 2
        raw = b"".join([(int(x) % p).to_bytes(nb, "little") for x in xs])
        g = (
            np.frombuffer(raw, np.uint8)
            .reshape(n, Lp // 2, 3)
            .astype(np.int32)
        )
        out = np.empty((n, Lp // 2, 2), np.int32)
        out[..., 0] = g[..., 0] | ((g[..., 1] & 0xF) << 8)
        out[..., 1] = (g[..., 1] >> 4) | (g[..., 2] << 4)
        return np.ascontiguousarray(out.reshape(n, Lp)[:, :L])

    def batch_from_limbs(self, arr) -> list[int]:
        """(n, num_limbs) canonical limbs -> list of ints mod p (inverse of
        batch_to_limbs; same bytes-vectorized scheme)."""
        arr = np.ascontiguousarray(np.asarray(arr, np.int64))
        flat = arr.reshape(-1, arr.shape[-1])
        n, L = flat.shape
        if n == 0:
            return []
        if (flat < 0).any() or (flat >> LIMB_BITS).any():
            # non-canonical limbs: exact per-row path
            return [self.from_limbs(row) for row in flat]
        Lp = L + (L & 1)
        nb = 3 * Lp // 2
        if Lp != L:
            flat = np.pad(flat, ((0, 0), (0, Lp - L)))
        pair = flat.reshape(n, Lp // 2, 2)
        g = np.empty((n, Lp // 2, 3), np.uint8)
        g[..., 0] = pair[..., 0] & 0xFF
        g[..., 1] = (pair[..., 0] >> 8) | ((pair[..., 1] & 0xF) << 4)
        g[..., 2] = pair[..., 1] >> 4
        data = g.tobytes()
        p = self.p
        return [
            int.from_bytes(data[i * nb : (i + 1) * nb], "little") % p
            for i in range(n)
        ]

    def to_mont(self, x: int) -> int:
        return x * self.r % self.p

    def from_mont(self, x: int) -> int:
        return x * pow(self.r, -1, self.p) % self.p

    # -- misc ---------------------------------------------------------------

    @functools.cached_property
    def two_adicity(self) -> int:
        n, s = self.p - 1, 0
        while n % 2 == 0:
            n //= 2
            s += 1
        return s

    @functools.cached_property
    def smallest_qnr(self) -> int:
        """Smallest quadratic non-residue; doubles as the FFT coset
        generator (a QNR is never inside a 2^k subgroup with k < 2-adicity,
        since all such subgroup elements are squares)."""
        p = self.p
        for g in range(2, 1000):
            if pow(g, (p - 1) // 2, p) == p - 1:
                return g
        raise RuntimeError("no small QNR found")

    # alias kept for call sites thinking in coset terms
    @property
    def multiplicative_generator(self) -> int:
        return self.smallest_qnr

    def root_of_unity(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity: qnr^((p-1)/2^s) has exact
        order 2^s (s = two_adicity); square down to 2^log_n."""
        s = self.two_adicity
        assert log_n <= s, f"{self.name}: 2-adicity {s} < {log_n}"
        y = pow(self.smallest_qnr, (self.p - 1) >> s, self.p)
        for _ in range(s - log_n):
            y = y * y % self.p
        return y


# ---------------------------------------------------------------------------
# Curve-family parameter derivations (self-validating)
# ---------------------------------------------------------------------------

# BN254 (alt_bn128).  Family polynomials from the BN construction:
#   p = 36x^4 + 36x^3 + 24x^2 + 6x + 1,  r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
BN254_X = 4965661367192848881
BN254_P = 36 * BN254_X**4 + 36 * BN254_X**3 + 24 * BN254_X**2 + 6 * BN254_X + 1
BN254_R = 36 * BN254_X**4 + 36 * BN254_X**3 + 18 * BN254_X**2 + 6 * BN254_X + 1
# Cross-check against the universally published decimal constants.
assert BN254_P == 21888242871839275222246405745257275088696311157297823662689037894645226208583
assert BN254_R == 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BLS12-377.  x is the curve seed; r = x^4 - x^2 + 1, p = ((x-1)^2 * r)/3 + x.
BLS12_377_X = 0x8508C00000000001
BLS12_377_R = BLS12_377_X**4 - BLS12_377_X**2 + 1
BLS12_377_P = ((BLS12_377_X - 1) ** 2 * BLS12_377_R) // 3 + BLS12_377_X
assert BLS12_377_P.bit_length() == 377 and _is_prime(BLS12_377_P)
assert BLS12_377_R.bit_length() == 253 and _is_prime(BLS12_377_R)
# BLS12-377 Fr has 2-adicity 47 — load-bearing for the NTT design.
assert (BLS12_377_R - 1) % (1 << 46) == 0

# BLS12-381.  x = -0xd201000000010000.
BLS12_381_X = -0xD201000000010000
BLS12_381_R = BLS12_381_X**4 - BLS12_381_X**2 + 1
BLS12_381_P = ((BLS12_381_X - 1) ** 2 * BLS12_381_R) // 3 + BLS12_381_X
assert BLS12_381_P.bit_length() == 381 and _is_prime(BLS12_381_P)
assert BLS12_381_R.bit_length() == 255 and _is_prime(BLS12_381_R)
# EIP-4844 blobs need 2^12-th roots of unity in BLS12-381 Fr.
assert (BLS12_381_R - 1) % (1 << 12) == 0

# BW6-761 (Housni-Guillevic, one-layer composition over BLS12-377).
# Same seed as BLS12-377; p from the published degree-12 family polynomial.
_BW6_U = BLS12_377_X
BW6_761_P = (
    103 * _BW6_U**12
    - 379 * _BW6_U**11
    + 250 * _BW6_U**10
    + 691 * _BW6_U**9
    - 911 * _BW6_U**8
    - 79 * _BW6_U**7
    + 623 * _BW6_U**6
    - 640 * _BW6_U**5
    + 274 * _BW6_U**4
    + 763 * _BW6_U**3
    + 73 * _BW6_U**2
    + 254 * _BW6_U
    + 229
) // 9
assert BW6_761_P.bit_length() == 761 and _is_prime(BW6_761_P)
# BW6-761's scalar field is BLS12-377's base field (the whole point of the
# construction: BW6 Groth16 proofs can verify BLS12-377 proofs natively).
BW6_761_R = BLS12_377_P

# secp256k1 (Ethereum ECDSA).
SECP256K1_P = 2**256 - 2**32 - 977
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
assert _is_prime(SECP256K1_P) and _is_prime(SECP256K1_N)

# BabyJubJub subgroup order (embedded twisted Edwards curve over BN254 Fr).
# Curve order = 8 * BABYJUBJUB_L.
BABYJUBJUB_L = 2736030358979909402780800718157159386076813972158567259200215660948447373041
assert _is_prime(BABYJUBJUB_L)


def _limbs_for(bits: int) -> int:
    """Limb count rounded up to a multiple of 2 for friendlier layouts.

    At least one spare bit above the modulus is REQUIRED: the branchless
    kernels hold intermediate values in [0, 2p), so L*LIMB_BITS must
    exceed bits (a field of exactly L*12 bits silently wraps — caught by
    the toy 2-chain's 168-bit scalar field)."""
    n = -(-(bits + 1) // LIMB_BITS)
    return n + (n % 2)


# ---------------------------------------------------------------------------
# The field registry
# ---------------------------------------------------------------------------

bn254_fp = FieldSpec("bn254_fp", BN254_P, _limbs_for(254))           # 22 limbs
bn254_fr = FieldSpec("bn254_fr", BN254_R, _limbs_for(254))           # 22 limbs
bls12_377_fp = FieldSpec("bls12_377_fp", BLS12_377_P, _limbs_for(377))  # 32
bls12_377_fr = FieldSpec("bls12_377_fr", BLS12_377_R, _limbs_for(253))  # 22
bw6_761_fp = FieldSpec("bw6_761_fp", BW6_761_P, _limbs_for(761))     # 64
bw6_761_fr = bls12_377_fp                                            # alias
bls12_381_fp = FieldSpec("bls12_381_fp", BLS12_381_P, _limbs_for(381))  # 32
bls12_381_fr = FieldSpec("bls12_381_fr", BLS12_381_R, _limbs_for(255))  # 22
secp256k1_fp = FieldSpec("secp256k1_fp", SECP256K1_P, _limbs_for(256))  # 22
secp256k1_fn = FieldSpec("secp256k1_fn", SECP256K1_N, _limbs_for(256))  # 22

FIELDS: dict[str, FieldSpec] = {
    f.name: f
    for f in (
        bn254_fp,
        bn254_fr,
        bls12_377_fp,
        bls12_377_fr,
        bw6_761_fp,
        bls12_381_fp,
        bls12_381_fr,
        secp256k1_fp,
        secp256k1_fn,
    )
}
