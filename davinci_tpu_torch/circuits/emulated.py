"""Non-native ("emulated") field arithmetic inside the R1CS frontend.

This is the foundation of the recursion chain: circuits over one scalar
field verifying statements about another field — the role of gnark's
`std/math/emulated` package used by every recursive circuit in the
reference (circuits/voteverifier/vote_verifier.go:71-87 `emulated.Element
[sw_bn254.ScalarField]`, circuits/statetransition verifying BW6-761 and
BLS12-381 inside BN254, crypto/blobs/evaluation.go:61-147).

Representation: an emulated element is a vector of limb LinCombs in base
2^w with a tracked per-limb integer bound.  Additions are lazy (free);
multiplication allocates the quotient/remainder via a hint and enforces

    a(X) * b(X) - q(X) * p(X) - r(X)  ==  0   at X = 2^w over the integers

with a sequential signed-carry chain: each carry is hint-allocated and
range-checked (shifted to non-negative), so no native-field wraparound can
occur (all intermediate magnitudes stay below the native modulus).  This
is the classical bits-based CRT-free approach; with Groth16 (no lookups)
bit decomposition is the optimal range check.

Cost (mul, BN254 emulated in BLS12-377-Fr, w=88/3 limbs): ~1k constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb


@dataclass
class EmuVar:
    """Emulated field element: limb LinCombs (little-endian base 2^w) plus a
    uniform per-limb integer upper bound."""

    limbs: list
    bound: int


class EmulatedOps:
    """Field operations over an emulated prime field, generating R1CS
    constraints in the native field of `cs`."""

    def __init__(
        self,
        cs: ConstraintSystem,
        emu_p: int,
        limb_bits: int | None = None,
        n_limbs: int | None = None,
        range_checker=None,
    ):
        """range_checker: optional circuits.lookup.LookupRangeChecker —
        routes all value-only range checks through the log-derivative
        lookup (O(1)/chunk with the commitment extension) instead of bit
        decomposition (O(bits)).  The caller finalizes the checker."""
        self.cs = cs
        self.p = emu_p
        self.range_checker = range_checker
        native_bits = cs.p.bit_length()
        emu_bits = emu_p.bit_length()
        if limb_bits is None:
            # largest w with 2w + margin under the native capacity
            margin = 24  # lazy-add overflow + carry + accumulation headroom
            w = (native_bits - 1 - margin) // 2
            n = -(-emu_bits // w)
            # rebalance: shrink w to the minimum for the same limb count
            w = -(-emu_bits // n)
            limb_bits = w
        self.w = limb_bits
        self.n = n_limbs or -(-emu_bits // limb_bits)
        assert self.n * self.w >= emu_bits
        # soundness budget: products + accumulation + carry must not wrap
        self._mul_bound_bits = (native_bits - 1 - self.n.bit_length() - 3) // 2
        assert self._mul_bound_bits > self.w, "limb width too large for native field"
        self.zero = self.constant(0)
        self.one = self.constant(1)

    # -- construction --------------------------------------------------------

    def _split(self, v: int) -> list[int]:
        v %= self.p
        mask = (1 << self.w) - 1
        return [(v >> (self.w * i)) & mask for i in range(self.n)]

    def constant(self, v: int) -> EmuVar:
        limbs = [self.cs.constant(x) for x in self._split(v)]
        return EmuVar(limbs, (1 << self.w) - 1)

    def alloc(self, v: int) -> EmuVar:
        """Allocate a witness element (canonical representative), range
        checking every limb."""
        limbs = []
        for x in self._split(v):
            lv = self.cs.priv_input(x)
            self._range_check(lv, self.w)
            limbs.append(lv)
        return EmuVar(limbs, (1 << self.w) - 1)

    def _range_check(self, v, nbits: int):
        if self.range_checker is not None:
            self.range_checker.range_check(v, nbits)
        else:
            self.cs.to_bits(v, nbits)

    def from_limb_vars(self, limbs, bound: int) -> EmuVar:
        return EmuVar(list(limbs), bound)

    def bind_native(self, v) -> EmuVar:
        """An emulated element EQUAL (as an integer) to the native LinComb
        `v` — the circuit-4 direction of cross-field binding: BN254-native
        blob cells embedded into emulated BLS12-381 Fr (reference
        circuits/statetransition VerifyBlobs data binding).

        Requires emu_p >= native p (the embedding is injective).  Limbs
        are allocated from the true value; a limb-wise canonical
        comparison enforces the recomposed integer < native_p, which makes
        the native recomposition equality exact over the integers — no
        mod-p representative ambiguity on either side."""
        cs = self.cs
        assert self.p >= cs.p, "bind_native embeds small field into large"
        v = cs.coerce(v)
        if v.is_constant():
            return self.constant(v.value)
        mask = (1 << self.w) - 1
        val = v.value
        limbs = []
        for i in range(self.n):
            lv = cs.priv_input((val >> (self.w * i)) & mask)
            self._range_check(lv, self.w)
            limbs.append(lv)
        self._assert_limbs_lt_const(limbs, cs.p)
        acc = cs.constant(0)
        for i, l in enumerate(limbs):
            acc = acc + l * (1 << (self.w * i))
        cs.assert_eq(acc, v)
        return EmuVar(limbs, mask)

    def _assert_limbs_lt_const(self, limbs, bound: int):
        """sum(limbs[i] * 2^(w*i)) < bound, each limb already range-checked
        to w bits.  Standard msb-first compare: one (geq-bit, remainder)
        split + one equality flag per limb."""
        cs = self.cs
        assert bound < 1 << (self.n * self.w)
        bl = [(bound >> (self.w * i)) & ((1 << self.w) - 1) for i in range(self.n)]
        lt = cs.constant(0)  # strict-less established at a higher limb
        eq = cs.one          # all higher limbs equal
        for i in reversed(range(self.n)):
            li, bi = limbs[i], bl[i]
            # t = [li >= bi]:  li - bi + 2^w == t*2^w + rem, rem in [0, 2^w)
            diff_val = li.value - bi + (1 << self.w)
            t_val, rem_val = divmod(diff_val, 1 << self.w)
            t = cs.priv_input(t_val)
            cs.assert_bool(t)
            rem = cs.priv_input(rem_val)
            self._range_check(rem, self.w)
            cs.assert_eq(li - bi + (1 << self.w), t * (1 << self.w) + rem)
            lt = lt + cs.mul(eq, cs.one - t)
            eq = cs.mul(eq, cs.is_zero(li - bi))
        cs.assert_eq(lt, cs.one)

    # -- host values (hints) -------------------------------------------------

    def raw_int(self, a: EmuVar) -> int:
        """The represented integer (pre-reduction); limb values are true
        integers because bounds stay below the native modulus."""
        return sum(l.value << (self.w * i) for i, l in enumerate(a.limbs))

    def value(self, a: EmuVar) -> int:
        return self.raw_int(a) % self.p

    # -- linear ops (free) ---------------------------------------------------

    def add(self, a: EmuVar, b: EmuVar) -> EmuVar:
        a, b = self._harmonize(a, b)
        limbs = [x + y for x, y in zip(a.limbs, b.limbs)]
        return self._maybe_reduce(EmuVar(limbs, a.bound + b.bound))

    def smul(self, a: EmuVar, k: int) -> EmuVar:
        """Multiply by a small non-negative integer constant."""
        assert k >= 0
        if k == 0:
            return self.zero
        return self._maybe_reduce(
            EmuVar([x * k for x in a.limbs], a.bound * k)
        )

    def cmul(self, a: EmuVar, k: int) -> EmuVar:
        """Multiply by an arbitrary field constant.  Small constants scale
        limbs lazily (free); large ones run a constant-side convolution —
        all product columns are LINEAR in a's limbs, so the only cost is
        the quotient/remainder allocation + carry chain (~60% of a mul)."""
        k %= self.p
        if k == 0:
            return self.zero
        if (a.bound * k).bit_length() <= self._mul_bound_bits:
            return EmuVar([x * k for x in a.limbs], a.bound * k)
        a = self._maybe_reduce(a)
        k_limbs = self._split_exact(k)
        v = self.raw_int(a) * k
        q_int, r_int = divmod(v, self.p)
        q = self._alloc_q(q_int, max(1, self._int_max(a) * k // self.p))
        r = self.alloc(r_int)
        a_ints = [l.value for l in a.limbs]
        K = len(a.limbs) + len(k_limbs) - 1
        cols = [self.cs.constant(0) for _ in range(K)]
        col_ints = [0] * K
        col_maxes = [0] * K
        for i, al in enumerate(a.limbs):
            for j, kj in enumerate(k_limbs):
                if kj:
                    cols[i + j] = cols[i + j] + al * kj
                    col_ints[i + j] += a_ints[i] * kj
                    col_maxes[i + j] += a.bound * kj
        R, R_ints, R_max = self._qr_terms(q, r)
        self._carry_check(cols, col_ints, R, R_ints, col_maxes, R_max)
        return r

    def lincomb(self, terms) -> EmuVar:
        """sum_i k_i * x_i for constant k_i — ONE quotient/remainder/carry
        check for the whole combination (the emulated-Poseidon MDS trick):
        all product columns are linear in the x limbs."""
        terms = [(x, k % self.p) for x, k in terms]
        terms = [(self._maybe_reduce(x), k) for x, k in terms if k]
        if not terms:
            return self.zero
        v = sum(self.raw_int(x) * k for x, k in terms)
        q_int, r_int = divmod(v, self.p)
        q_max = max(
            1, sum(self._int_max(x) * k for x, k in terms) // self.p
        )
        q = self._alloc_q(q_int, q_max)
        r = self.alloc(r_int)
        K = max(
            len(x.limbs) + len(self._split_exact(k)) - 1 for x, k in terms
        )
        cols = [self.cs.constant(0) for _ in range(K)]
        col_ints = [0] * K
        col_maxes = [0] * K
        for x, k in terms:
            k_limbs = self._split_exact(k)
            x_ints = [l.value for l in x.limbs]
            for i, xl in enumerate(x.limbs):
                for j, kj in enumerate(k_limbs):
                    if kj:
                        cols[i + j] = cols[i + j] + xl * kj
                        col_ints[i + j] += x_ints[i] * kj
                        col_maxes[i + j] += x.bound * kj
        R, R_ints, R_max = self._qr_terms(q, r)
        self._carry_check(cols, col_ints, R, R_ints, col_maxes, R_max)
        return r

    def sub(self, a: EmuVar, b: EmuVar) -> EmuVar:
        """a - b, made limb-wise non-negative by adding a multiple of p whose
        every limb dominates b's bound."""
        a, b = self._harmonize(a, b)
        pad = self._sub_padding(b.bound, len(b.limbs))
        limbs = [
            x + self.cs.constant(pd) - y
            for x, y, pd in zip(a.limbs, b.limbs, pad)
        ]
        return self._maybe_reduce(EmuVar(limbs, a.bound + max(pad)))

    def neg(self, a: EmuVar) -> EmuVar:
        return self.sub(self.zero, a)

    def _sub_padding(self, bound: int, k: int) -> list[int]:
        """Integer limbs of a multiple of p with every limb >= bound."""
        base = sum(bound << (self.w * i) for i in range(k))
        delta = (-base) % self.p
        mask = (1 << self.w) - 1
        out = [bound + ((delta >> (self.w * i)) & mask) for i in range(k)]
        # delta < p <= 2^(w*n); if k < n limbs can't hold it — harmonize
        # callers keep k == n so this holds:
        assert delta >> (self.w * k) == 0
        return out

    def _harmonize(self, a: EmuVar, b: EmuVar):
        """Equalize limb counts (pad with zeros)."""
        zero = self.cs.constant(0)
        n = max(len(a.limbs), len(b.limbs), self.n)
        if len(a.limbs) < n:
            a = EmuVar(a.limbs + [zero] * (n - len(a.limbs)), a.bound)
        if len(b.limbs) < n:
            b = EmuVar(b.limbs + [zero] * (n - len(b.limbs)), b.bound)
        return a, b

    def _maybe_reduce(self, a: EmuVar) -> EmuVar:
        if a.bound.bit_length() > self._mul_bound_bits:
            return self.reduce(a)
        return a

    # -- the carry-chain core ------------------------------------------------

    def _carry_check(self, L, L_ints, R, R_ints, L_maxes=None, R_maxes=None):
        """Assert sum_k (L_k - R_k) 2^(wk) == 0 over the integers.

        L/R: lists of LinCombs; L_ints/R_ints: their true integer values;
        L_maxes/R_maxes: STATIC upper bounds per column (from tracked limb
        bounds — never from witness values, so the circuit structure is
        witness-independent and proving keys are reusable).  Signed carries
        are hint-allocated and range-checked after an offset shift."""
        cs, w = self.cs, self.w
        K = max(len(L), len(R))
        zero = cs.constant(0)
        L = list(L) + [zero] * (K - len(L))
        R = list(R) + [zero] * (K - len(R))
        L_ints = list(L_ints) + [0] * (K - len(L_ints))
        R_ints = list(R_ints) + [0] * (K - len(R_ints))
        if L_maxes is None:
            L_maxes = [(1 << (2 * self.w)) * self.n] * K
        if R_maxes is None:
            R_maxes = L_maxes
        L_maxes = list(L_maxes) + [0] * (K - len(L_maxes))
        R_maxes = list(R_maxes) + [0] * (K - len(R_maxes))

        carry = zero
        carry_int = 0
        carry_abs_max = 0
        for k in range(K):
            d = L[k] + carry - R[k]
            d_int = L_ints[k] + carry_int - R_ints[k]
            assert abs(d_int) <= L_maxes[k] + R_maxes[k] + carry_abs_max
            if k == K - 1:
                assert d_int == 0, "emulated identity does not hold (bad hint)"
                cs.assert_zero(d)
                break
            assert d_int % (1 << w) == 0, "carry chain misaligned"
            c_int = d_int >> w
            col_max = L_maxes[k] + R_maxes[k] + carry_abs_max
            # native-field wraparound guard for the shifted range check
            assert col_max.bit_length() + 3 < cs.p.bit_length()
            carry_abs_max = (col_max >> w) + 1
            cb = max(carry_abs_max.bit_length(), 1)
            c = cs.priv_input(c_int % cs.p)
            cs.raw_constrain(c, cs.one, d * pow(2, -w, cs.p))
            # range check the shifted carry: c + 2^cb in [0, 2^(cb+1))
            self._range_check(c + (1 << cb), cb + 1)
            carry, carry_int = c, c_int

    def _mul_limb_products(self, a: EmuVar, b: EmuVar):
        """Column sums of a*b: LinComb products (n^2 constraints), their
        integer values, and static column maxima."""
        cs = self.cs
        na, nb = len(a.limbs), len(b.limbs)
        a_ints = [l.value for l in a.limbs]
        b_ints = [l.value for l in b.limbs]
        cols = [cs.constant(0) for _ in range(na + nb - 1)]
        col_ints = [0] * (na + nb - 1)
        col_maxes = [0] * (na + nb - 1)
        for i in range(na):
            for j in range(nb):
                cols[i + j] = cols[i + j] + cs.mul(a.limbs[i], b.limbs[j])
                col_ints[i + j] += a_ints[i] * b_ints[j]
                col_maxes[i + j] += a.bound * b.bound
        return cols, col_ints, col_maxes

    def _qr_terms(self, q: EmuVar, r: EmuVar):
        """Columns of q*p + r (linear in q's limbs: p's limbs are constants)."""
        cs = self.cs
        p_limbs = self._split_exact(self.p)
        nq, np_ = len(q.limbs), len(p_limbs)
        q_ints = [l.value for l in q.limbs]
        K = max(nq + np_ - 1, len(r.limbs))
        cols = [cs.constant(0) for _ in range(K)]
        col_ints = [0] * K
        col_maxes = [0] * K
        for i in range(nq):
            for j in range(np_):
                if p_limbs[j]:
                    cols[i + j] = cols[i + j] + q.limbs[i] * p_limbs[j]
                    col_ints[i + j] += q_ints[i] * p_limbs[j]
                    col_maxes[i + j] += q.bound * p_limbs[j]
        for k, l in enumerate(r.limbs):
            cols[k] = cols[k] + l
            col_ints[k] += l.value
            col_maxes[k] += r.bound
        return cols, col_ints, col_maxes

    def _split_exact(self, v: int) -> list[int]:
        mask = (1 << self.w) - 1
        out = []
        while v:
            out.append(v & mask)
            v >>= self.w
        return out or [0]

    def _alloc_q(self, q_int: int, q_max: int) -> EmuVar:
        nq = max(1, -(-q_max.bit_length() // self.w))
        mask = (1 << self.w) - 1
        limbs = []
        for i in range(nq):
            x = (q_int >> (self.w * i)) & mask
            lv = self.cs.priv_input(x)
            self._range_check(lv, self.w)
            limbs.append(lv)
        return EmuVar(limbs, (1 << self.w) - 1)

    # -- multiplicative ops --------------------------------------------------

    def _int_max(self, a: EmuVar) -> int:
        return sum(a.bound << (self.w * i) for i in range(len(a.limbs)))

    def _const_val(self, a: EmuVar) -> int | None:
        """The element's value if every limb is a constant LinComb."""
        if all(l.is_constant() for l in a.limbs):
            return self.raw_int(a) % self.p
        return None

    def mul(self, a: EmuVar, b: EmuVar) -> EmuVar:
        # constant folding: towers are full of structurally-constant
        # coordinates (sparse line evaluations, nonresidue columns); a
        # constant operand degrades to cmul (linear columns, ~60% of a
        # mul) or to a free fold
        ka, kb = self._const_val(a), self._const_val(b)
        if ka is not None and kb is not None:
            return self.constant(ka * kb % self.p)
        if ka is not None:
            return self.cmul(b, ka)
        if kb is not None:
            return self.cmul(a, kb)
        a = self._maybe_reduce(a)
        b = self._maybe_reduce(b)
        v = self.raw_int(a) * self.raw_int(b)
        q_int, r_int = divmod(v, self.p)
        q_max = self._int_max(a) * self._int_max(b) // self.p
        q = self._alloc_q(q_int, q_max)
        r = self.alloc(r_int)
        L, L_ints, L_max = self._mul_limb_products(a, b)
        R, R_ints, R_max = self._qr_terms(q, r)
        self._carry_check(L, L_ints, R, R_ints, L_max, R_max)
        return r

    def square(self, a: EmuVar) -> EmuVar:
        return self.mul(a, a)

    # -- aggregated sum-of-products (ONE reduction for many muls) ------------

    supports_sum_products = True

    # host constant algebra for the tower flattening (algebra.py
    # _TowerSumProducts): leaf values are SIGNED representatives mod p so
    # nonresidue-derived multipliers stay small
    def h_signed(self, v: int) -> int:
        v = int(v) % self.p
        return v - self.p if v > self.p // 2 else v

    def h_is_zero(self, v) -> bool:
        return int(v) % self.p == 0

    def h_add(self, a: int, b: int) -> int:
        return self.h_signed(int(a) + int(b))

    def h_mul(self, a: int, b: int) -> int:
        return self.h_signed(int(a) * int(b))

    def _limb_prod(self, la, lb):
        """Cached product wire of two limb LinCombs: tower flattening
        re-uses the same limb pairs across output coordinates, and each
        pair needs only one R1CS product constraint ever."""
        if la.is_constant():
            return lb * la.value if la.value else None
        if lb.is_constant():
            return la * lb.value if lb.value else None
        cache = getattr(self, "_prod_cache", None)
        if cache is None:
            cache = self._prod_cache = {}
        key = (id(la), id(lb)) if id(la) <= id(lb) else (id(lb), id(la))
        # entries hold strong refs to (la, lb): id() keys are only valid
        # while the operands are alive (a freed LinComb's id can be
        # recycled, silently aliasing a different product wire)
        hit = cache.get(key)
        if hit is not None:
            return hit[2]
        out = self.cs.mul(la, lb)
        cache[key] = (la, lb, out)
        return out

    def sum_products(self, terms, lin=()) -> EmuVar:
        """r = (sum_t m_t * a_t * b_t  +  sum_u k_u * x_u) mod p with ONE
        quotient/remainder allocation and ONE carry chain — the lazy-
        reduction core that lets tower multiplication reduce once per
        OUTPUT COORDINATE instead of once per base-field product (gnark's
        std/math/emulated mulmod-aggregation role; the dominant cost of
        the in-circuit pairing, reference circuits/voteverifier).

        terms: iterable of (a, b, m): EmuVar x EmuVar x signed int
        multiplier (small — nonresidue-derived).  lin: iterable of
        (x, m): EmuVar x signed int.  Negative multipliers are handled by
        padding the affected columns with a multiple of p (the sub()
        scheme lifted to product columns), so limb values stay
        non-negative and the carry chain stays sound."""
        cs, w, p = self.cs, self.w, self.p
        norm_terms = []
        const_int = 0  # fully-constant contributions, as a plain integer
        lin_small = []  # (x, m) small signed
        lin_big = []  # (x, c) large positive constant coefficient
        for a, b, m in terms:
            m = self.h_signed(int(m))
            if m == 0:
                continue
            assert abs(m) < (1 << 20), "sum_products multiplier too large"
            ka, kb = self._const_val(a), self._const_val(b)
            if ka is not None and kb is not None:
                const_int += m * ka * kb
                continue
            if ka is not None:
                a, ka, kb = b, kb, ka
            if kb is not None:
                c = kb * m
                if abs(c) < (1 << 20):
                    lin_small.append((a, c))
                else:
                    lin_big.append((self._maybe_reduce(a), c % p))
                continue
            norm_terms.append((a, b, m))
        for x, m in lin:
            m = self.h_signed(int(m))
            if m == 0:
                continue
            kx = self._const_val(x)
            if kx is not None:
                const_int += m * kx
            elif abs(m) < (1 << 20):
                lin_small.append((x, m))
            else:
                lin_big.append((self._maybe_reduce(x), m % p))
        if not norm_terms and not lin_small and not lin_big:
            return self.constant(const_int % p)

        # pre-reduce operands until the worst-case column total fits the
        # native field with carry headroom (static bounds only: the
        # decision depends on tracked bounds, never witness values)
        cap_bits = cs.p.bit_length() - 6
        norm_terms = [
            (self._maybe_reduce(a), self._maybe_reduce(b), m)
            for a, b, m in norm_terms
        ]
        lin_small = [(self._maybe_reduce(x), m) for x, m in lin_small]
        while True:
            worst = sum(
                abs(m) * a.bound * b.bound * min(len(a.limbs), len(b.limbs))
                for a, b, m in norm_terms
            ) + sum(abs(m) * x.bound for x, m in lin_small) + sum(
                x.bound * ((1 << w) - 1) * len(x.limbs) for x, _ in lin_big
            )
            if worst.bit_length() < cap_bits or not norm_terms:
                break
            # reduce the fattest product operand
            fat_i = max(
                range(len(norm_terms)),
                key=lambda i: max(
                    norm_terms[i][0].bound, norm_terms[i][1].bound
                ),
            )
            a, b, m = norm_terms[fat_i]
            if a.bound >= b.bound:
                a = self.reduce(a)
            else:
                b = self.reduce(b)
            norm_terms[fat_i] = (a, b, m)

        K = max(
            [len(a.limbs) + len(b.limbs) - 1 for a, b, _ in norm_terms]
            + [len(x.limbs) for x, _ in lin_small]
            + [
                len(x.limbs) + len(self._split_exact(c)) - 1
                for x, c in lin_big
            ]
            + [self.n]
        )
        zero = cs.constant(0)
        cols = [zero for _ in range(K)]
        col_ints = [0] * K
        col_pos = [0] * K  # static upper bound of positive contributions
        col_neg = [0] * K  # static upper bound of |negative| contributions
        for a, b, m in norm_terms:
            a_ints = [l.value for l in a.limbs]
            b_ints = [l.value for l in b.limbs]
            bb = a.bound * b.bound * abs(m)
            for i in range(len(a.limbs)):
                for j in range(len(b.limbs)):
                    prod = self._limb_prod(a.limbs[i], b.limbs[j])
                    if prod is None:
                        continue
                    cols[i + j] = cols[i + j] + prod * m
                    col_ints[i + j] += a_ints[i] * b_ints[j] * m
                    if m > 0:
                        col_pos[i + j] += bb
                    else:
                        col_neg[i + j] += bb
        for x, m in lin_small:
            for i, l in enumerate(x.limbs):
                cols[i] = cols[i] + l * m
                col_ints[i] += l.value * m
                if m > 0:
                    col_pos[i] += x.bound * abs(m)
                else:
                    col_neg[i] += x.bound * abs(m)
        for x, c in lin_big:
            c_limbs = self._split_exact(c)
            x_ints = [l.value for l in x.limbs]
            for i in range(len(x.limbs)):
                for j, cj in enumerate(c_limbs):
                    if cj:
                        cols[i + j] = cols[i + j] + x.limbs[i] * cj
                        col_ints[i + j] += x_ints[i] * cj
                        col_pos[i + j] += x.bound * cj
        # constant contribution (may be negative: fold into the padding)
        ci = const_int
        if ci > 0:
            for i, cl in enumerate(self._split_exact(ci)):
                if i >= K:
                    K_new = i + 1
                    cols += [zero] * (K_new - K)
                    col_ints += [0] * (K_new - K)
                    col_pos += [0] * (K_new - K)
                    col_neg += [0] * (K_new - K)
                    K = K_new
                if cl:
                    cols[i] = cols[i] + cs.constant(cl)
                    col_ints[i] += cl
                    col_pos[i] += cl
        elif ci < 0:
            col_neg[0] += -ci
            col_ints[0] += ci  # integer truth; pad restores positivity

        if any(col_neg):
            # one multiple of p whose column limbs dominate every negative
            # bound: total = sum col_neg[c] 2^(wc) rounded up to = 0 mod p
            base = sum(cn << (w * c) for c, cn in enumerate(col_neg))
            delta = (-base) % p
            assert delta >> (w * K) == 0, "padding exceeds column span"
            mask = (1 << w) - 1
            for c in range(K):
                pad_c = col_neg[c] + ((delta >> (w * c)) & mask)
                if pad_c:
                    cols[c] = cols[c] + cs.constant(pad_c)
                    col_ints[c] += pad_c
                    col_pos[c] += pad_c
        assert all(v >= 0 for v in col_ints), "negative column after padding"

        v = sum(ci2 << (w * c) for c, ci2 in enumerate(col_ints))
        q_int, r_int = divmod(v, p)
        q_max = max(1, sum(cp << (w * c) for c, cp in enumerate(col_pos)) // p)
        q = self._alloc_q(q_int, q_max)
        r = self.alloc(r_int)
        R, R_ints, R_max = self._qr_terms(q, r)
        self._carry_check(cols, col_ints, R, R_ints, col_pos, R_max)
        return r

    def reduce(self, a: EmuVar) -> EmuVar:
        """Canonical representative (< p, limbs range-checked)."""
        v = self.raw_int(a)
        q_int, r_int = divmod(v, self.p)
        q = self._alloc_q(q_int, max(1, self._int_max(a) // self.p))
        r = self.alloc(r_int)
        a_ints = [l.value for l in a.limbs]
        R, R_ints, R_max = self._qr_terms(q, r)
        self._carry_check(
            list(a.limbs), a_ints, R, R_ints,
            [a.bound] * len(a.limbs), R_max,
        )
        return r

    def inv(self, a: EmuVar) -> EmuVar:
        av = self.value(a)
        x = self.alloc(pow(av, -1, self.p) if av else 0)
        self.assert_eq(self.mul(a, x), self.one)
        return x

    def div(self, a: EmuVar, b: EmuVar) -> EmuVar:
        bv = self.value(b)
        out = self.alloc(
            self.value(a) * pow(bv, -1, self.p) % self.p if bv else 0
        )
        self.assert_eq(self.mul(b, out), a)
        return out

    # -- predicates / control ------------------------------------------------

    def assert_is_zero(self, a: EmuVar):
        v = self.raw_int(a)
        assert v % self.p == 0, "assert_is_zero on nonzero value"
        q_int = v // self.p
        q = self._alloc_q(q_int, max(1, self._int_max(a) // self.p))
        a_ints = [l.value for l in a.limbs]
        R, R_ints, R_max = self._qr_terms(q, self.zero)
        self._carry_check(
            list(a.limbs), a_ints, R, R_ints,
            [a.bound] * len(a.limbs), R_max,
        )

    def assert_eq(self, a: EmuVar, b: EmuVar):
        self.assert_is_zero(self.sub(a, b))

    def select(self, cond, a: EmuVar, b: EmuVar) -> EmuVar:
        """cond ? a : b (cond: boolean LinComb)."""
        a, b = self._harmonize(a, b)
        limbs = [self.cs.select(cond, x, y) for x, y in zip(a.limbs, b.limbs)]
        return EmuVar(limbs, max(a.bound, b.bound))

    def is_zero(self, a: EmuVar):
        """Boolean LinComb: 1 iff a == 0 mod p."""
        cs = self.cs
        av = self.value(a)
        out = cs.priv_input(1 if av == 0 else 0)
        cs.assert_bool(out)
        m = self.alloc(pow(av, -1, self.p) if av else 0)
        # out=1 -> a == 0 ; out=0 -> a*m == 1 (a invertible)
        t = self.mul(a, m)
        self.assert_eq(t, self.select(out, self.zero, self.one))
        s = self.select(out, a, self.zero)
        self.assert_is_zero(s)
        return out

    def to_canonical_bits(self, a: EmuVar) -> list:
        """Bit decomposition of the canonical value (little-endian, w*n bits)
        with a canonicity check (value < p)."""
        r = self.reduce(a)
        bits = []
        for l in r.limbs:
            bits.extend(self.cs.to_bits(l, self.w))
        self._assert_lt_p(bits)
        return bits

    def _assert_lt_p(self, bits):
        """Lexicographic less-than against the constant p."""
        cs = self.cs
        p_bits = [(self.p >> i) & 1 for i in range(len(bits))]
        # standard MSB-first comparison: ok = OR over positions where
        # p_bit=1 and all higher bits equal and this bit of a is 0
        eq_so_far = cs.one
        lt = cs.constant(0)
        for i in reversed(range(len(bits))):
            b = cs.coerce(bits[i])
            if p_bits[i] == 1:
                # a can be less here: bit 0 while prefix equal
                lt = lt + cs.mul(eq_so_far, cs.one - b)
                eq_so_far = cs.mul(eq_so_far, b)
            else:
                # p bit is 0: a bit must be 0 to stay equal
                eq_so_far = cs.mul(eq_so_far, cs.one - b)
        cs.assert_eq(lt, cs.one)
