"""Host-side generic field towers (Fp, Fp2, Fp3, Fp6, Fp12) used by the
setup/verification path and as the spec oracle for device kernels.

Everything here is arbitrary-precision Python int math — the *reference
implementation* the TPU kernels are tested against.  The proving hot path
never runs through this module.

Tower shapes per curve (matching the standard constructions the reference's
gnark-crypto dependency uses):
  BN254:      Fp2 = Fp[u]/(u^2+1),  Fp6 = Fp2[v]/(v^3-(9+u)),  Fp12 = Fp6[w]/(w^2-v)
  BLS12-377:  Fp2 = Fp[u]/(u^2-(-5)), Fp6 = Fp2[v]/(v^3-u),    Fp12 = Fp6[w]/(w^2-v)
  BLS12-381:  Fp2 = Fp[u]/(u^2+1),  Fp6 = Fp2[v]/(v^3-(1+u)),  Fp12 = Fp6[w]/(w^2-v)
  BW6-761:    Fp3 = Fp[u]/(u^3+4),  Fp6 = Fp3[v]/(v^2-u)
"""

from __future__ import annotations


class FF:
    """A field element: value(s) + a reference to its field object."""

    __slots__ = ("fld", "v")

    def __init__(self, fld, v):
        self.fld = fld
        self.v = v

    def __add__(self, o):
        return FF(self.fld, self.fld.add(self.v, o.v))

    def __sub__(self, o):
        return FF(self.fld, self.fld.sub(self.v, o.v))

    def __mul__(self, o):
        if isinstance(o, int):
            return FF(self.fld, self.fld.smul(self.v, o))
        return FF(self.fld, self.fld.mul(self.v, o.v))

    __rmul__ = __mul__

    def __neg__(self):
        return FF(self.fld, self.fld.neg(self.v))

    def __eq__(self, o):
        return self.fld is o.fld and self.v == o.v

    def __hash__(self):
        return hash((id(self.fld), repr(self.v)))

    def inv(self):
        return FF(self.fld, self.fld.inv(self.v))

    def square(self):
        return FF(self.fld, self.fld.mul(self.v, self.v))

    def is_zero(self):
        return self.fld.is_zero(self.v)

    def __pow__(self, e: int):
        result = self.fld.one_ff()
        base = self
        if e < 0:
            base = base.inv()
            e = -e
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __repr__(self):
        return f"FF({self.fld.name}, {self.v})"


class Fp:
    """Prime field wrapper (values are ints)."""

    def __init__(self, p: int, name: str = "fp"):
        self.p = p
        self.name = name
        self.degree = 1

    def __call__(self, v: int) -> FF:
        return FF(self, v % self.p)

    def from_int(self, v: int) -> FF:
        return self(v)

    def one_ff(self):
        return self(1)

    def zero_ff(self):
        return self(0)

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def smul(self, a, k: int):
        return a * k % self.p

    def neg(self, a):
        return (-a) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def is_zero(self, a):
        return a == 0

    def rand(self, rng):
        return self(rng.randrange(self.p))


class QuadExt:
    """Quadratic extension K[u]/(u^2 - nr); values are (a0, a1) tuples of
    base-field *raw* values."""

    def __init__(self, base, nr_ff: FF, name: str):
        self.base = base
        self.nr = nr_ff.v  # raw base value
        self.name = name
        self.degree = 2 * base.degree

    def __call__(self, a0: FF, a1: FF) -> FF:
        return FF(self, (a0.v, a1.v))

    def from_base(self, a0: FF) -> FF:
        return FF(self, (a0.v, self.base.zero_ff().v))

    def from_int(self, v: int) -> FF:
        return self.from_base(self.base.from_int(v))

    def one_ff(self):
        return self.from_base(self.base.one_ff())

    def zero_ff(self):
        return self.from_base(self.base.zero_ff())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def smul(self, a, k: int):
        return (self.base.smul(a[0], k), self.base.smul(a[1], k))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul(self, a, b):
        B = self.base
        t0 = B.mul(a[0], b[0])
        t1 = B.mul(a[1], b[1])
        # (a0+a1)(b0+b1) - t0 - t1
        mid = B.sub(B.sub(B.mul(B.add(a[0], a[1]), B.add(b[0], b[1])), t0), t1)
        return (B.add(t0, B.mul(t1, self.nr)), mid)

    def mul_by_nonresidue(self, a):
        """Multiply by u (the adjoined root): (a0,a1) -> (nr*a1, a0)."""
        return (self.base.mul(a[1], self.nr), a[0])

    def conj(self, a):
        return (a[0], self.base.neg(a[1]))

    def inv(self, a):
        B = self.base
        # norm = a0^2 - nr*a1^2
        norm = B.sub(B.mul(a[0], a[0]), B.mul(self.nr, B.mul(a[1], a[1])))
        ninv = B.inv(norm)
        return (B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv)))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) and self.base.is_zero(a[1])

    def rand(self, rng):
        return FF(self, (self.base.rand(rng).v, self.base.rand(rng).v))


class CubicExt:
    """Cubic extension K[v]/(v^3 - nr)."""

    def __init__(self, base, nr_ff: FF, name: str):
        self.base = base
        self.nr = nr_ff.v
        self.name = name
        self.degree = 3 * base.degree

    def __call__(self, a0: FF, a1: FF, a2: FF) -> FF:
        return FF(self, (a0.v, a1.v, a2.v))

    def from_base(self, a0: FF) -> FF:
        z = self.base.zero_ff().v
        return FF(self, (a0.v, z, z))

    def from_int(self, v: int) -> FF:
        return self.from_base(self.base.from_int(v))

    def one_ff(self):
        return self.from_base(self.base.one_ff())

    def zero_ff(self):
        return self.from_base(self.base.zero_ff())

    def add(self, a, b):
        B = self.base
        return tuple(B.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        B = self.base
        return tuple(B.sub(x, y) for x, y in zip(a, b))

    def smul(self, a, k: int):
        return tuple(self.base.smul(x, k) for x in a)

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        B, nr = self.base, self.nr
        t0 = B.mul(a[0], b[0])
        t1 = B.mul(a[1], b[1])
        t2 = B.mul(a[2], b[2])
        c0 = B.add(
            t0,
            B.mul(
                nr,
                B.sub(
                    B.sub(B.mul(B.add(a[1], a[2]), B.add(b[1], b[2])), t1), t2
                ),
            ),
        )
        c1 = B.add(
            B.sub(B.sub(B.mul(B.add(a[0], a[1]), B.add(b[0], b[1])), t0), t1),
            B.mul(nr, t2),
        )
        c2 = B.add(
            B.sub(B.sub(B.mul(B.add(a[0], a[2]), B.add(b[0], b[2])), t0), t2),
            t1,
        )
        return (c0, c1, c2)

    def mul_by_nonresidue(self, a):
        """Multiply by v: (a0,a1,a2) -> (nr*a2, a0, a1)."""
        return (self.base.mul(a[2], self.nr), a[0], a[1])

    def inv(self, a):
        B, nr = self.base, self.nr
        a0, a1, a2 = a
        t0 = B.mul(a0, a0)
        t1 = B.mul(a1, a1)
        t2 = B.mul(a2, a2)
        t3 = B.mul(a0, a1)
        t4 = B.mul(a0, a2)
        t5 = B.mul(a1, a2)
        c0 = B.sub(t0, B.mul(nr, t5))
        c1 = B.sub(B.mul(nr, t2), t3)
        c2 = B.sub(t1, t4)
        # a0*c0 + nr*(a2*c1 + a1*c2)
        d = B.add(
            B.mul(a0, c0),
            B.mul(nr, B.add(B.mul(a2, c1), B.mul(a1, c2))),
        )
        dinv = B.inv(d)
        return (B.mul(c0, dinv), B.mul(c1, dinv), B.mul(c2, dinv))

    def is_zero(self, a):
        return all(self.base.is_zero(x) for x in a)

    def rand(self, rng):
        return FF(self, tuple(self.base.rand(rng).v for _ in range(3)))
