"""Host-side elliptic curve layer: curve specs (self-derived, self-validated)
plus arbitrary-precision affine point arithmetic.

This is the spec oracle + setup/verify path.  Device (batched/jit) curve ops
live in davinci_tpu_torch.ec.

All pairing-friendly curves used by the stack have j-invariant 0
(y^2 = x^3 + b), so subgroup orders of curves and twists are derived from
Cornacchia's algorithm (4q = t^2 + 3v^2) and validated by random-point order
checks at import time — no trusted constants beyond the seeds in fields.py
and the protocol-pinned generators (BN254 G1=(1,2), secp256k1 G, BabyJubJub).

Reference parity: replaces crypto/ecc of vocdoni/davinci-node
(crypto/ecc/curve.go:13-60 Point interface; bjj_gnark, bls12377te, bn254
implementations) and the gnark-crypto curve packages behind them.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from functools import cached_property

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.towers import FF, CubicExt, Fp, QuadExt

# ---------------------------------------------------------------------------
# Generic affine point ops (work over any FF field)
# ---------------------------------------------------------------------------


class AffinePoint:
    """Affine point on y^2 = x^3 + b over an FF field; None coords = infinity."""

    __slots__ = ("curve", "x", "y")

    def __init__(self, curve: "CurveSpec", x: FF | None, y: FF | None):
        self.curve = curve
        self.x = x
        self.y = y

    @property
    def infinity(self) -> bool:
        return self.x is None

    def __eq__(self, o):
        return self.curve is o.curve and self.x == o.x and self.y == o.y

    def __repr__(self):
        if self.infinity:
            return f"Point({self.curve.name}, inf)"
        return f"Point({self.curve.name}, {self.x.v}, {self.y.v})"

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return self.y.square() == self.x.square() * self.x + self.curve.b_ff

    def neg(self):
        if self.infinity:
            return self
        return AffinePoint(self.curve, self.x, -self.y)

    def add(self, o: "AffinePoint") -> "AffinePoint":
        if self.infinity:
            return o
        if o.infinity:
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return AffinePoint(self.curve, None, None)
            # doubling
            lam = (3 * self.x.square()) * (2 * self.y).inv()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(self.curve, x3, y3)

    def double(self):
        return self.add(self)

    def mul(self, k: int) -> "AffinePoint":
        k = int(k)
        if k < 0:
            return self.neg().mul(-k)
        acc = AffinePoint(self.curve, None, None)
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.double()
            k >>= 1
        return acc


# ---------------------------------------------------------------------------
# Square roots over arbitrary FF fields (generic Tonelli-Shanks)
# ---------------------------------------------------------------------------


def field_order(fld) -> int:
    if isinstance(fld, Fp):
        return fld.p
    if isinstance(fld, QuadExt):
        return field_order(fld.base) ** 2
    if isinstance(fld, CubicExt):
        return field_order(fld.base) ** 3
    raise TypeError(type(fld))


def sqrt_ff(a: FF) -> FF | None:
    """Tonelli-Shanks over any finite field (odd order)."""
    fld = a.fld
    q = field_order(fld)
    if a.is_zero():
        return fld.zero_ff()
    if a ** ((q - 1) // 2) != fld.one_ff():
        return None
    if q % 4 == 3:
        return a ** ((q + 1) // 4)
    s, t = 0, q - 1
    while t % 2 == 0:
        t //= 2
        s += 1
    rng = random.Random(0xC0FFEE)
    while True:
        z = fld.rand(rng)
        if not z.is_zero() and z ** ((q - 1) // 2) != fld.one_ff():
            break
    m, c, u, r_ = s, z**t, a**t, a ** ((t + 1) // 2)
    one = fld.one_ff()
    while u != one:
        i, t2 = 0, u
        while t2 != one:
            t2 = t2.square()
            i += 1
        b = c ** (1 << (m - i - 1))
        m, c = i, b.square()
        u, r_ = u * c, r_ * b
    return r_


# ---------------------------------------------------------------------------
# j=0 order derivation via Cornacchia
# ---------------------------------------------------------------------------


def _sqrt_mod(a: int, p: int) -> int:
    spec_like = F.FieldSpec.__new__(F.FieldSpec)  # lightweight: reuse sqrt
    # implement directly to avoid FieldSpec construction cost
    a %= p
    if p % 4 == 3:
        r = pow(a, (p + 1) // 4, p)
    else:
        # Tonelli-Shanks on ints
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
    assert r * r % p == a % p, "not a QR"
    return r


def j0_candidate_orders(q: int) -> list[int]:
    """All 6 possible orders of y^2 = x^3 + b curves over GF(q) (j=0),
    via Cornacchia: q = a^2 + 3b^2 -> traces {±2a, ±(a+3b), ±(a-3b)}."""
    # Cornacchia for x^2 + 3 y^2 = q
    x0 = _sqrt_mod(-3, q)
    if x0 % 2 == 0:
        x0 = q - x0
    a, b = q, x0
    limit = math.isqrt(q)
    while b > limit:
        a, b = b, a % b
    c2, rem = divmod(q - b * b, 3)
    assert rem == 0, "Cornacchia failure"
    c = math.isqrt(c2)
    assert c * c == c2, "Cornacchia failure (non-square)"
    aa, bb = b, c  # q = aa^2 + 3 bb^2
    traces = {2 * aa, -2 * aa, aa + 3 * bb, -(aa + 3 * bb), aa - 3 * bb, -(aa - 3 * bb)}
    return sorted(q + 1 - t for t in traces)


# ---------------------------------------------------------------------------
# CurveSpec
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class CurveSpec:
    """A short-Weierstrass curve y^2 = x^3 + b with a designated prime-order
    subgroup of order r and cofactor h."""

    name: str
    fld: object          # Fp / QuadExt / CubicExt instance for coordinates
    field_spec: object   # FieldSpec of the *base* prime field (device layout)
    b_ff: FF
    r: int               # subgroup order (scalar field size)
    h: int               # cofactor
    gen: AffinePoint = None

    def infinity(self) -> AffinePoint:
        return AffinePoint(self, None, None)

    def point(self, x, y) -> AffinePoint:
        if isinstance(x, int):
            x = self.fld(x)
            y = self.fld(y)
        pt = AffinePoint(self, x, y)
        assert pt.is_on_curve(), f"{self.name}: point not on curve"
        return pt

    def find_generator(self) -> AffinePoint:
        """Deterministic generator: smallest x giving a curve point whose
        cofactor-cleared image has exact order r."""
        x = 0
        while True:
            x += 1
            xf = self.fld.from_int(x)
            rhs = xf * xf * xf + self.b_ff
            y = sqrt_ff(rhs)
            if y is None:
                continue
            pt = AffinePoint(self, xf, y)
            g = pt.mul(self.h)
            if g.infinity:
                continue
            assert g.mul(self.r).infinity, f"{self.name}: bad group order"
            return g

    def validate(self, samples: int = 1):
        """Random-point order validation: h*r kills every curve point."""
        rng = random.Random(42)
        n = self.h * self.r
        found = 0
        while found < samples:
            xf = self.fld.rand(rng)
            y = sqrt_ff(xf * xf * xf + self.b_ff)
            if y is None:
                continue
            pt = AffinePoint(self, xf, y)
            assert pt.mul(n).infinity, f"{self.name}: order validation failed"
            found += 1


# ---------------------------------------------------------------------------
# Curve constructions
# ---------------------------------------------------------------------------

# ---- base prime fields (host) ----
fp_bn254 = Fp(F.BN254_P, "bn254.fp")
fp_bls377 = Fp(F.BLS12_377_P, "bls377.fp")
fp_bls381 = Fp(F.BLS12_381_P, "bls381.fp")
fp_bw6 = Fp(F.BW6_761_P, "bw6.fp")
fp_secp = Fp(F.SECP256K1_P, "secp.fp")

# ---- towers ----
fp2_bn254 = QuadExt(fp_bn254, fp_bn254(-1), "bn254.fp2")
fp2_bls377 = QuadExt(fp_bls377, fp_bls377(-5), "bls377.fp2")
fp2_bls381 = QuadExt(fp_bls381, fp_bls381(-1), "bls381.fp2")

xi_bn254 = fp2_bn254(fp_bn254(9), fp_bn254(1))        # 9 + u
xi_bls377 = fp2_bls377(fp_bls377(0), fp_bls377(1))    # u
xi_bls381 = fp2_bls381(fp_bls381(1), fp_bls381(1))    # 1 + u

fp6_bn254 = CubicExt(fp2_bn254, xi_bn254, "bn254.fp6")
fp6_bls377 = CubicExt(fp2_bls377, xi_bls377, "bls377.fp6")
fp6_bls381 = CubicExt(fp2_bls381, xi_bls381, "bls381.fp6")

fp12_bn254 = QuadExt(fp6_bn254, fp6_bn254.from_base(fp2_bn254.zero_ff()), "bn254.fp12")
fp12_bls377 = QuadExt(fp6_bls377, fp6_bls377.from_base(fp2_bls377.zero_ff()), "bls377.fp12")
fp12_bls381 = QuadExt(fp6_bls381, fp6_bls381.from_base(fp2_bls381.zero_ff()), "bls381.fp12")
# Fp12 = Fp6[w]/(w^2 - v): the non-residue is v, i.e. (0,1,0) in Fp6
for _f6, _f12 in ((fp6_bn254, fp12_bn254), (fp6_bls377, fp12_bls377), (fp6_bls381, fp12_bls381)):
    _f12.nr = (_f6.base.zero_ff().v, _f6.base.one_ff().v, _f6.base.zero_ff().v)

# ---- G1 curves ----

# BN254 G1: y^2 = x^3 + 3, generator (1,2) — protocol-pinned (Ethereum).
bn254_g1 = CurveSpec("bn254_g1", fp_bn254, F.bn254_fp, fp_bn254(3), F.BN254_R, 1)
bn254_g1.gen = bn254_g1.point(1, 2)
assert bn254_g1.gen.mul(F.BN254_R).infinity

# BLS12-377 G1: y^2 = x^3 + 1; cofactor h1 = (x-1)^2/3 (BLS family).
_h1_377 = (F.BLS12_377_X - 1) ** 2 // 3
assert F.BLS12_377_P + 1 - (F.BLS12_377_X + 1) == _h1_377 * F.BLS12_377_R
bls377_g1 = CurveSpec(
    "bls377_g1", fp_bls377, F.bls12_377_fp, fp_bls377(1), F.BLS12_377_R, _h1_377
)
bls377_g1.gen = bls377_g1.find_generator()

# BLS12-381 G1: y^2 = x^3 + 4; same family cofactor formula.
_h1_381 = (F.BLS12_381_X - 1) ** 2 // 3
assert F.BLS12_381_P + 1 - (F.BLS12_381_X + 1) == _h1_381 * F.BLS12_381_R
bls381_g1 = CurveSpec(
    "bls381_g1", fp_bls381, F.bls12_381_fp, fp_bls381(4), F.BLS12_381_R, _h1_381
)
bls381_g1.gen = bls381_g1.find_generator()

# BW6-761 G1: y^2 = x^3 - 1; order derived via Cornacchia (j=0).
_bw6_orders = j0_candidate_orders(F.BW6_761_P)
_bw6_n = [n for n in _bw6_orders if n % F.BW6_761_R == 0]
assert len(_bw6_n) >= 1, "no BW6 candidate order divisible by r"


def _match_j0_curve(fld, q, r, b_candidates, orders):
    """Find (b, n) such that y^2 = x^3 + b over fld has order n = h*r.
    Tests candidate orders against random points (probabilistically exact:
    a wrong order kills a random point with negligible probability)."""
    rng = random.Random(7)
    for b in b_candidates:
        b_ff = fld(b) if isinstance(b, int) else b
        # find one random point
        while True:
            xf = fld.rand(rng)
            y = sqrt_ff(xf * xf * xf + b_ff)
            if y is not None:
                break
        spec = CurveSpec("probe", fld, None, b_ff, r, 1)
        pt = AffinePoint(spec, xf, y)
        for n in orders:
            if n % r == 0 and pt.mul(n).infinity:
                # confirm with a second random point
                while True:
                    xf2 = fld.rand(rng)
                    y2 = sqrt_ff(xf2 * xf2 * xf2 + b_ff)
                    if y2 is not None:
                        break
                if AffinePoint(spec, xf2, y2).mul(n).infinity:
                    return b_ff, n
    raise AssertionError("no matching j=0 curve/order")


_bw6_b, _bw6_order = _match_j0_curve(
    fp_bw6, F.BW6_761_P, F.BW6_761_R, [-1], _bw6_orders
)
bw6_g1 = CurveSpec(
    "bw6_g1", fp_bw6, F.bw6_761_fp, _bw6_b, F.BW6_761_R, _bw6_order // F.BW6_761_R
)
bw6_g1.gen = bw6_g1.find_generator()

# BW6-761 G2: the sextic twist also lives over Fp (761-bit); find its b and
# order among the same candidate set.
_bw6_g2_b, _bw6_g2_order = _match_j0_curve(
    fp_bw6, F.BW6_761_P, F.BW6_761_R, [4, 2, 3, 5, 6, 7],
    [n for n in _bw6_orders if n != _bw6_order] + _bw6_orders,
)
bw6_g2 = CurveSpec(
    "bw6_g2", fp_bw6, F.bw6_761_fp, _bw6_g2_b, F.BW6_761_R,
    _bw6_g2_order // F.BW6_761_R,
)
bw6_g2.gen = bw6_g2.find_generator()

# secp256k1: y^2 = x^3 + 7, standard generator (protocol-pinned: Ethereum).
secp256k1 = CurveSpec(
    "secp256k1", fp_secp, F.secp256k1_fp, fp_secp(7), F.SECP256K1_N, 1
)
secp256k1.gen = secp256k1.point(
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
assert secp256k1.gen.mul(F.SECP256K1_N).infinity

# ---- G2 curves (over Fp2) ----


def _g2_curve(name, fp2, fld_spec, xi, b_base: int, q, r, d_type: bool):
    """Build the G2 sextic-twist curve: b' = b/xi (D-type) or b*xi (M-type);
    order derived via Cornacchia over GF(q^2)."""
    b = fp2.from_base(fp2.base(b_base) if isinstance(fp2.base, Fp) else b_base)
    b_tw = b * xi.inv() if d_type else b * xi
    orders = j0_candidate_orders_sq(q)
    b_ff, n = _match_j0_curve(fp2, q * q, r, [b_tw], orders)
    return CurveSpec(name, fp2, fld_spec, b_ff, r, n // r)


def j0_candidate_orders_sq(q: int) -> list[int]:
    """Candidate orders over GF(q^2) from the GF(q) Cornacchia solution:
    q = a^2+3b^2 -> q^2 = (a^2-3b^2)^2 + 3(2ab)^2."""
    x0 = _sqrt_mod(-3, q)
    if x0 % 2 == 0:
        x0 = q - x0
    a, b = q, x0
    limit = math.isqrt(q)
    while b > limit:
        a, b = b, a % b
    c2, rem = divmod(q - b * b, 3)
    assert rem == 0
    c = math.isqrt(c2)
    assert c * c == c2
    aa, bb = b, c
    A, B = aa * aa - 3 * bb * bb, 2 * aa * bb  # q^2 = A^2 + 3 B^2
    traces = {2 * A, -2 * A, A + 3 * B, -(A + 3 * B), A - 3 * B, -(A - 3 * B)}
    return sorted(q * q + 1 - t for t in traces)


# BN254 G2: D-type twist, b' = 3/(9+u).
bn254_g2 = _g2_curve(
    "bn254_g2", fp2_bn254, F.bn254_fp, xi_bn254, 3, F.BN254_P, F.BN254_R, True
)
bn254_g2.gen = bn254_g2.find_generator()

# BLS12-377 G2: D-type twist, b' = 1/u.
bls377_g2 = _g2_curve(
    "bls377_g2", fp2_bls377, F.bls12_377_fp, xi_bls377, 1,
    F.BLS12_377_P, F.BLS12_377_R, True,
)
bls377_g2.gen = bls377_g2.find_generator()

# BLS12-381 G2: M-type twist, b' = 4*(1+u).
bls381_g2 = _g2_curve(
    "bls381_g2", fp2_bls381, F.bls12_381_fp, xi_bls381, 4,
    F.BLS12_381_P, F.BLS12_381_R, False,
)
bls381_g2.gen = bls381_g2.find_generator()


# ---------------------------------------------------------------------------
# Twisted Edwards curves (BabyJubJub)
# ---------------------------------------------------------------------------


@dataclass
class EdwardsSpec:
    """a*x^2 + y^2 = 1 + d*x^2*y^2 over fld; prime subgroup order l,
    cofactor 8."""

    name: str
    fld: Fp
    field_spec: object
    a: int
    d: int
    l: int
    cofactor: int
    gen: tuple = None    # full-order generator G
    base8: tuple = None  # prime-subgroup base point (iden3 "Base8")

    def on_curve(self, pt) -> bool:
        x, y = pt
        p = self.fld.p
        return (self.a * x * x + y * y) % p == (1 + self.d * x * x * y * y) % p

    def add(self, p1, p2):
        x1, y1 = p1
        x2, y2 = p2
        p = self.fld.p
        dxy = self.d * x1 * x2 * y1 * y2 % p
        x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, p) % p
        y3 = (y1 * y2 - self.a * x1 * x2) * pow(1 - dxy, -1, p) % p
        return (x3, y3)

    def mul(self, pt, k: int):
        acc = (0, 1)
        add = pt
        k = int(k)
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc


# BabyJubJub over BN254 Fr — protocol-pinned iden3 constants
# (reference crypto/ecc/bjj_iden3, curve order 8*l).
babyjubjub = EdwardsSpec(
    "babyjubjub",
    Fp(F.BN254_R, "bn254.fr"),
    F.bn254_fr,
    a=168700,
    d=168696,
    l=F.BABYJUBJUB_L,
    cofactor=8,
)
babyjubjub.gen = (
    995203441582195749578291179787384436505546430278305826713579947235728471134,
    5472060717959818805561601436314318772137091100104008585924551046643952123905,
)
babyjubjub.base8 = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)
assert babyjubjub.on_curve(babyjubjub.gen), "BabyJubJub generator invalid"
assert babyjubjub.on_curve(babyjubjub.base8), "BabyJubJub Base8 invalid"
assert babyjubjub.mul(babyjubjub.base8, F.BABYJUBJUB_L) == (0, 1)
assert babyjubjub.mul(babyjubjub.gen, 8) != (0, 1)
assert babyjubjub.mul(babyjubjub.gen, 8 * F.BABYJUBJUB_L) == (0, 1)
