"""BabyJubJub in Reduced Twisted Edwards (RTE) form — the protocol's wire
coordinate system.

The reference exposes points in gnark's RTE convention (reference
crypto/ecc/bjj_gnark/babyjubjub.go:169-176 Point(); scaling factor at :27-32)
while iden3 tooling uses the classic TE form (a=168700, d=168696).  The two
are related by x_te = f * x_rte with f^2 = -1/168700 mod r: substituting into
a*x^2 + y^2 = 1 + d*x^2*y^2 gives the RTE curve -x^2 + y^2 = 1 + d' x^2 y^2
with d' = -168696/168700.  All parameters below are *derived* from that
algebra and asserted, including that the published scaling factor squares to
-1/a.
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.curves import babyjubjub as bjj_te

R = F.BN254_R

# gnark's published scaling factor (reference bjj_gnark/babyjubjub.go:31):
# f^2 = -a_te, so x_rte = f * x_te maps (a=168700, d) onto (a'=-1, d'=d/f^2)
SCALING_F = 6360561867910373094066688120553762416144456282423235903351243436111059670888
assert SCALING_F * SCALING_F % R == (R - bjj_te.a) % R, "f^2 != -a"

A_RTE = R - 1  # a' = a_te / f^2 = -1
D_RTE = bjj_te.d * pow(SCALING_F * SCALING_F % R, -1, R) % R  # d' = d_te / f^2


def te_to_rte(pt: tuple) -> tuple:
    """(x_te, y) -> (x_rte, y): x_rte = f * x_te."""
    x, y = pt
    return (x * SCALING_F % R, y % R)


def rte_to_te(pt: tuple) -> tuple:
    x, y = pt
    return (x * pow(SCALING_F, -1, R) % R, y % R)


@dataclass(frozen=True)
class BJJ:
    """Immutable RTE-coordinate BabyJubJub point."""

    x: int
    y: int

    def is_identity(self) -> bool:
        return self.x == 0 and self.y == 1

    def on_curve(self) -> bool:
        x2 = self.x * self.x % R
        y2 = self.y * self.y % R
        return (A_RTE * x2 + y2) % R == (1 + D_RTE * x2 % R * y2) % R

    def add(self, o: "BJJ") -> "BJJ":
        x1, y1, x2, y2 = self.x, self.y, o.x, o.y
        dxy = D_RTE * x1 % R * x2 % R * y1 % R * y2 % R
        x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, R) % R
        y3 = (y1 * y2 - A_RTE * x1 % R * x2) * pow(1 - dxy, -1, R) % R
        return BJJ(x3, y3)

    def neg(self) -> "BJJ":
        return BJJ((-self.x) % R, self.y)

    def mul(self, k: int) -> "BJJ":
        k = int(k) % ORDER if k >= ORDER or k < 0 else int(k)
        acc = IDENTITY
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.add(add)
            k >>= 1
        return acc

    def coords(self) -> tuple:
        return (self.x, self.y)


IDENTITY = BJJ(0, 1)
ORDER = F.BABYJUBJUB_L  # prime subgroup order (gnark Params.Order)

# generator: gnark's Base = the prime-subgroup base point = iden3 Base8 in RTE
GENERATOR = BJJ(*te_to_rte(bjj_te.base8))
assert GENERATOR.on_curve(), "RTE generator not on derived curve"
assert GENERATOR.mul(ORDER).is_identity(), "RTE generator order mismatch"


class bjj_rte:
    """Curve handle mirroring the reference ecc.Point interface essentials."""

    name = "bjj_gnark"
    order = ORDER
    generator = GENERATOR
    identity = IDENTITY

    @staticmethod
    def base_mul(k: int) -> BJJ:
        return GENERATOR.mul(k)
