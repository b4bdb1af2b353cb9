"""In-circuit algebra: native field ops, extension-tower ops, and affine
curve gadgets — generic over the underlying field-ops provider, so the SAME
tower/pairing/curve code serves both native 2-chain recursion (BLS12-377
arithmetic inside a BW6-761 circuit — reference circuits/aggregator) and
emulated recursion (BN254 inside BLS12-377 — reference circuits/voteverifier
via gnark sw_bn254; BW6-761 inside BN254 — circuits/statetransition).

Conventions:
  * elements of an ops provider are opaque (LinComb for NativeOps, EmuVar
    for EmulatedOps, tuples for extension towers);
  * division/inversion go through hints (1 mul + 1 constraint in R1CS),
    which makes *affine* curve formulas optimal in-circuit (gnark does the
    same);
  * incomplete additions use `inv` so degenerate cases are UNSATISFIABLE
    (never under-constrained): a malicious witness cannot exploit P == ±Q.
"""

from __future__ import annotations

import hashlib

from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb


class _TowerSumProducts:
    """Lazy-reduction tower multiplication over a sum-of-products base.

    When the base ops provider exposes `sum_products` (EmulatedOps — ONE
    quotient/remainder/carry chain for a whole weighted sum of products),
    tower multiplication flattens recursively down to base-coordinate
    product terms, so an Fp12 mul reduces once per OUTPUT COORDINATE
    (12 reductions) instead of once per base-field product (~54 with
    Karatsuba) — the dominant cost of emulated pairings (reference
    circuits/voteverifier via gnark std/math/emulated lazy reduction).
    Native bases don't set the flag and keep the Karatsuba paths (a
    native product is a single constraint; flattening would add work).

    Host-side constant ("h_*") values: ints are universal scalars at any
    level; tuples carry per-coordinate base host values.  Multipliers stay
    small (nonresidue products) — the leaf signs-reduces mod p.
    """

    @property
    def supports_sum_products(self) -> bool:
        return getattr(self.base, "supports_sum_products", False)

    # -- host constant algebra ----------------------------------------------

    def h_signed(self, v):
        if isinstance(v, int):
            return self.base.h_signed(v)
        return tuple(self.base.h_signed(x) for x in v)

    def h_is_zero(self, v) -> bool:
        if isinstance(v, int):
            return v == 0
        return all(self.base.h_is_zero(x) for x in v)

    def h_add(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return a + b
        a, b = self.h_tuple(a), self.h_tuple(b)
        return tuple(self.base.h_add(x, y) for x, y in zip(a, b))

    def h_tuple(self, m):
        if isinstance(m, int):
            return (m,) + (0,) * (self.deg - 1)
        assert len(m) == self.deg
        return m

    @property
    def _h_nr(self):
        """Host value of the nonresidue (a base-level host constant)."""
        v = getattr(self, "_h_nr_cache", None)
        if v is None:
            v = self._h_nr_cache = self.h_signed_base(
                self.base.value(self.nr)
            )
        return v

    def h_signed_base(self, v):
        return self.base.h_signed(v)

    def h_mul(self, a, b):
        """Host product of two host values AT THIS LEVEL."""
        B = self.base
        if isinstance(a, int) and isinstance(b, int):
            return a * b
        if isinstance(a, int):
            return tuple(B.h_mul(a, x) for x in self.h_tuple(b))
        if isinstance(b, int):
            return tuple(B.h_mul(x, b) for x in self.h_tuple(a))
        out = [0] * self.deg
        for i, j, k, w in self._mul_tab():
            out[k] = B.h_add(out[k], B.h_mul(B.h_mul(w, a[i]), b[j]))
        return tuple(out)

    # -- the flattening ------------------------------------------------------

    def sum_products(self, terms, lin=()):
        """sum_t m_t * a_t * b_t + sum_u k_u * x_u, flattened into one
        base sum_products per output coordinate."""
        B = self.base
        d = self.deg
        tab = self._mul_tab()
        out_t = [[] for _ in range(d)]
        out_l = [[] for _ in range(d)]
        for a, b, m in terms:
            mt = self.h_tuple(m)
            # m . (a . b): compose the constant-mul structure (m as left
            # operand, coords l) with the product structure (coords i, j)
            for l, kp, k, w2 in tab:
                ml = mt[l]
                if B.h_is_zero(ml) if not isinstance(ml, int) else ml == 0:
                    continue
                w2m = B.h_mul(w2, ml)
                for i, j, kp2, w1 in tab:
                    if kp2 != kp:
                        continue
                    out_t[k].append((a[i], b[j], B.h_mul(w2m, w1)))
        for x, m in lin:
            mt = self.h_tuple(m)
            for l, kp, k, w2 in tab:
                ml = mt[l]
                if B.h_is_zero(ml) if not isinstance(ml, int) else ml == 0:
                    continue
                out_l[k].append((x[kp], B.h_mul(w2, ml)))
        return tuple(
            B.sum_products(out_t[k], out_l[k]) for k in range(d)
        )


class NativeOps:
    """Field ops over the circuit's own scalar field: elements are LinCombs."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.p = cs.p
        self.zero = cs.constant(0)
        self.one = cs.one

    def constant(self, v: int):
        return self.cs.constant(v)

    def alloc(self, v: int):
        return self.cs.priv_input(v)

    def value(self, a) -> int:
        return a.value

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return -a

    def smul(self, a, k: int):
        return a * k

    def cmul(self, a, k: int):
        """Multiply by a field constant — free (linear combination)."""
        return a * k

    def mul(self, a, b):
        return self.cs.mul(a, b)

    def square(self, a):
        return self.cs.mul(a, a)

    def inv(self, a):
        return self.cs.inv(a)

    def div(self, a, b):
        return self.cs.mul(a, self.cs.inv(b))

    def assert_eq(self, a, b):
        self.cs.assert_eq(a, b)

    def assert_is_zero(self, a):
        self.cs.assert_zero(a)

    def select(self, cond, a, b):
        return self.cs.select(cond, a, b)

    def is_zero(self, a):
        return self.cs.is_zero(a)


class QuadOps(_TowerSumProducts):
    """K[u]/(u^2 - nr) over a base ops provider.  Elements: (a0, a1)."""

    deg = 2

    def _mul_tab(self):
        # (i, j, out_coord, weight): a_i * b_j contributes weight to coord
        nr = self._h_nr
        return [(0, 0, 0, 1), (1, 1, 0, nr), (0, 1, 1, 1), (1, 0, 1, 1)]

    def __init__(self, base, nr, nr_mul=None):
        self.base = base
        self.cs = base.cs
        self.nr = nr  # base element (constant)
        # fast multiply-by-nonresidue (constant): defaults to a full mul
        self._nr_mul = nr_mul or (lambda a: base.mul(a, nr))
        self.zero = (base.zero, base.zero)
        self.one = (base.one, base.zero)

    def constant(self, v):
        """v: tuple of base constant values (matches towers.FF .v layout)."""
        return (self.base.constant(v[0]), self.base.constant(v[1]))

    def alloc(self, v):
        return (self.base.alloc(v[0]), self.base.alloc(v[1]))

    def from_base(self, a):
        return (a, self.base.zero)

    def value(self, a):
        return (self.base.value(a[0]), self.base.value(a[1]))

    def add(self, a, b):
        B = self.base
        return (B.add(a[0], b[0]), B.add(a[1], b[1]))

    def sub(self, a, b):
        B = self.base
        return (B.sub(a[0], b[0]), B.sub(a[1], b[1]))

    def neg(self, a):
        B = self.base
        return (B.neg(a[0]), B.neg(a[1]))

    def smul(self, a, k: int):
        B = self.base
        return (B.smul(a[0], k), B.smul(a[1], k))

    def mul(self, a, b):
        if self.supports_sum_products:
            return self.sum_products([(a, b, 1)])
        # Karatsuba: 3 base muls
        B = self.base
        t0 = B.mul(a[0], b[0])
        t1 = B.mul(a[1], b[1])
        mid = B.mul(B.add(a[0], a[1]), B.add(b[0], b[1]))
        mid = B.sub(B.sub(mid, t0), t1)
        return (B.add(t0, self._nr_mul(t1)), mid)

    def square(self, a):
        if self.supports_sum_products:
            return self.sum_products([(a, a, 1)])
        # complex squaring: 2 base muls + 2 nonresidue constant-muls
        B = self.base
        t = B.mul(a[0], a[1])
        c0 = B.mul(B.add(a[0], a[1]), B.add(a[0], self._nr_mul(a[1])))
        c0 = B.sub(B.sub(c0, t), self._nr_mul(t))
        return (c0, B.add(t, t))

    def mul_base(self, a, c):
        """Multiply by a base-field element."""
        B = self.base
        return (B.mul(a[0], c), B.mul(a[1], c))

    def mul_by_nonresidue(self, a):
        return (self._nr_mul(a[1]), a[0])

    def conj(self, a):
        return (a[0], self.base.neg(a[1]))

    def inv(self, a):
        B = self.base
        norm = B.sub(B.mul(a[0], a[0]), self._nr_mul(B.mul(a[1], a[1])))
        ninv = B.inv(norm)
        return (B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv)))

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def assert_eq(self, a, b):
        self.base.assert_eq(a[0], b[0])
        self.base.assert_eq(a[1], b[1])

    def assert_is_zero(self, a):
        self.base.assert_is_zero(a[0])
        self.base.assert_is_zero(a[1])

    def select(self, cond, a, b):
        B = self.base
        return (B.select(cond, a[0], b[0]), B.select(cond, a[1], b[1]))

    def is_zero(self, a):
        z0 = self.base.is_zero(a[0])
        z1 = self.base.is_zero(a[1])
        return self.cs.mul(z0, z1)


class CubicOps(_TowerSumProducts):
    """K[v]/(v^3 - nr) over a base ops provider.  Elements: (a0, a1, a2)."""

    deg = 3

    def _mul_tab(self):
        nr = self._h_nr
        return [
            (0, 0, 0, 1), (1, 2, 0, nr), (2, 1, 0, nr),
            (0, 1, 1, 1), (1, 0, 1, 1), (2, 2, 1, nr),
            (0, 2, 2, 1), (1, 1, 2, 1), (2, 0, 2, 1),
        ]

    def __init__(self, base, nr, nr_mul=None):
        self.base = base
        self.cs = base.cs
        self.nr = nr
        self._nr_mul = nr_mul or (lambda a: base.mul(a, nr))
        self.zero = (base.zero, base.zero, base.zero)
        self.one = (base.one, base.zero, base.zero)

    def constant(self, v):
        B = self.base
        return tuple(B.constant(x) for x in v)

    def alloc(self, v):
        B = self.base
        return tuple(B.alloc(x) for x in v)

    def from_base(self, a):
        return (a, self.base.zero, self.base.zero)

    def value(self, a):
        B = self.base
        return tuple(B.value(x) for x in a)

    def add(self, a, b):
        B = self.base
        return tuple(B.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        B = self.base
        return tuple(B.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        B = self.base
        return tuple(B.neg(x) for x in a)

    def smul(self, a, k: int):
        B = self.base
        return tuple(B.smul(x, k) for x in a)

    def mul(self, a, b):
        if self.supports_sum_products:
            return self.sum_products([(a, b, 1)])
        # Karatsuba-style (6 base muls), mirrors towers.CubicExt.mul
        B, nr = self.base, self.nr
        t0 = B.mul(a[0], b[0])
        t1 = B.mul(a[1], b[1])
        t2 = B.mul(a[2], b[2])
        m12 = B.mul(B.add(a[1], a[2]), B.add(b[1], b[2]))
        m01 = B.mul(B.add(a[0], a[1]), B.add(b[0], b[1]))
        m02 = B.mul(B.add(a[0], a[2]), B.add(b[0], b[2]))
        c0 = B.add(t0, self._nr_mul(B.sub(B.sub(m12, t1), t2)))
        c1 = B.add(B.sub(B.sub(m01, t0), t1), self._nr_mul(t2))
        c2 = B.add(B.sub(B.sub(m02, t0), t2), t1)
        return (c0, c1, c2)

    def square(self, a):
        if self.supports_sum_products:
            return self.sum_products([(a, a, 1)])
        return self.mul(a, a)

    def mul_base(self, a, c):
        B = self.base
        return tuple(B.mul(x, c) for x in a)

    def mul_by_nonresidue(self, a):
        return (self._nr_mul(a[2]), a[0], a[1])

    def inv(self, a):
        # mirrors towers.CubicExt.inv (c0,c1,c2 / norm)
        B, nr = self.base, self.nr
        a0, a1, a2 = a
        t0 = B.mul(a0, a0)
        t1 = B.mul(a1, a1)
        t2 = B.mul(a2, a2)
        t3 = B.mul(a0, a1)
        t4 = B.mul(a0, a2)
        t5 = B.mul(a1, a2)
        c0 = B.sub(t0, self._nr_mul(t5))
        c1 = B.sub(self._nr_mul(t2), t3)
        c2 = B.sub(t1, t4)
        d = B.add(
            B.mul(a0, c0), self._nr_mul(B.add(B.mul(a2, c1), B.mul(a1, c2)))
        )
        dinv = B.inv(d)
        return (B.mul(c0, dinv), B.mul(c1, dinv), B.mul(c2, dinv))

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def assert_eq(self, a, b):
        for x, y in zip(a, b):
            self.base.assert_eq(x, y)

    def assert_is_zero(self, a):
        for x in a:
            self.base.assert_is_zero(x)

    def select(self, cond, a, b):
        B = self.base
        return tuple(B.select(cond, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Affine short-Weierstrass curve gadget (a = 0)
# ---------------------------------------------------------------------------


class WeierstrassGadget:
    """Affine point ops over any coordinate ops provider.

    Points are (x, y) pairs of coordinate elements; the identity is not
    representable — the gadget targets pairing/MSM flows where identities
    are ruled out by offset techniques (see msm_with_aux).  Degenerate
    additions (P == ±Q) are made unsatisfiable via `inv`."""

    def __init__(self, coord_ops, b_const):
        self.F = coord_ops
        self.cs = coord_ops.cs
        self.b = b_const  # coordinate element (constant)

    def constant_point(self, pt):
        """Host AffinePoint -> constant gadget point."""
        assert not pt.infinity
        return (self._const_coord(pt.x.v), self._const_coord(pt.y.v))

    def alloc_point(self, pt):
        assert not pt.infinity
        return (self._alloc_coord(pt.x.v), self._alloc_coord(pt.y.v))

    def _const_coord(self, v):
        return self.F.constant(v)

    def _alloc_coord(self, v):
        return self.F.alloc(v)

    def value(self, P):
        return (self.F.value(P[0]), self.F.value(P[1]))

    def neg(self, P):
        return (P[0], self.F.neg(P[1]))

    def select(self, cond, P, Q):
        F = self.F
        return (F.select(cond, P[0], Q[0]), F.select(cond, P[1], Q[1]))

    def assert_on_curve(self, P):
        F = self.F
        x, y = P
        y2 = F.square(y)
        x3 = F.mul(F.square(x), x)
        F.assert_eq(y2, F.add(x3, self.b))

    def assert_eq(self, P, Q):
        self.F.assert_eq(P[0], Q[0])
        self.F.assert_eq(P[1], Q[1])

    def add_unequal(self, P, Q):
        """P + Q with x_P != x_Q enforced (unsatisfiable otherwise)."""
        F = self.F
        lam = F.mul(F.sub(Q[1], P[1]), F.inv(F.sub(Q[0], P[0])))
        x3 = F.sub(F.sub(F.square(lam), P[0]), Q[0])
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def double(self, P):
        """2P with y_P != 0 enforced (a = 0 curves: lam = 3x^2 / 2y)."""
        F = self.F
        lam = F.mul(F.smul(F.square(P[0]), 3), F.inv(F.smul(P[1], 2)))
        x3 = F.sub(F.square(lam), F.smul(P[0], 2))
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def double_and_add(self, P, Q):
        """2P + Q via two chained unequal additions (saves one y3)."""
        t = self.add_unequal(P, Q)
        return self.add_unequal(t, P)

    def msm_with_aux(self, bit_lists, bases, aux, nbits: int):
        """sum_i [s_i] K_i via the Straus shared-bit loop with a constant
        auxiliary offset making incomplete formulas honest-complete:

            acc = T;  for j: acc = 2 acc; acc += K_i if s_i[j]
            result = acc - [2^nbits] T

        bit_lists: per-scalar little-endian boolean LinComb lists (each of
        length nbits); bases: host AffinePoints (constants); aux: host
        AffinePoint T with unknown dlog relation to the bases — any
        collision in the incomplete adds would exhibit such a relation, so
        none occurs for ANY witness (unsat instead of wrap).  Degenerate
        results (true sum = identity) are unsatisfiable by design."""
        assert len(bit_lists) == len(bases)
        for bits in bit_lists:
            assert len(bits) == nbits
        acc = self.constant_point(aux)
        # bases: host AffinePoints (constants) or gadget points (variables,
        # e.g. the ECDSA public key) — the aux-offset completeness argument
        # covers both (a collision would exhibit a dlog relation with T)
        base_consts = [
            K if isinstance(K, tuple) else self.constant_point(K)
            for K in bases
        ]
        for j in reversed(range(nbits)):
            acc = self.double(acc)
            for bits, K in zip(bit_lists, base_consts):
                added = self.add_unequal(acc, K)
                acc = self.select(bits[j], added, acc)
        corr = aux.mul(1 << nbits).neg()
        return self.add_unequal(acc, self.constant_point(corr))


def aux_point(spec, seed: str = "davinci-tpu-aux-v1"):
    """Deterministic nothing-up-my-sleeve point on `spec` (try-and-increment
    over hash outputs).  Its discrete log w.r.t. any published generator is
    unknown, which is what msm_with_aux's completeness argument needs."""
    p = spec.fld.p if hasattr(spec.fld, "p") else None
    assert p is not None, "aux_point supports prime-field curves"
    b = spec.b_ff.v
    ctr = 0
    while True:
        h = hashlib.sha512(f"{seed}|{spec.name}|{ctr}".encode()).digest()
        x = int.from_bytes(h, "big") % p
        rhs = (pow(x, 3, p) + b) % p
        y = pow(rhs, (p + 1) // 4, p) if p % 4 == 3 else _sqrt_mod(rhs, p)
        if y is not None and y * y % p == rhs:
            from davinci_tpu_torch.curves import AffinePoint

            return AffinePoint(spec, spec.fld(x), spec.fld(y))
        ctr += 1


def _sqrt_mod(a: int, p: int):
    from davinci_tpu_torch.curves import _sqrt_mod as host_sqrt

    try:
        r = host_sqrt(a, p)
    except Exception:
        return None
    if r is None or r * r % p != a % p:
        return None
    return r


def assert_bits_lt_const(cs: ConstraintSystem, bits, bound: int):
    """Assert the little-endian boolean `bits` encode a value < bound
    (MSB-first lexicographic comparison against the constant)."""
    eq_so_far = cs.one
    lt = cs.constant(0)
    for i in reversed(range(len(bits))):
        b = cs.coerce(bits[i])
        if (bound >> i) & 1:
            lt = lt + cs.mul(eq_so_far, cs.one - b)
            eq_so_far = cs.mul(eq_so_far, b)
        else:
            eq_so_far = cs.mul(eq_so_far, cs.one - b)
    cs.assert_eq(lt, cs.one)
