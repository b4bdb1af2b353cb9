"""Log-derivative lookup range checks over the Groth16 commitment
extension — the feature that collapses emulated-arithmetic range-check
costs from O(bits) to O(1) constraints per chunk (gnark's
std/rangecheck-with-commitment role; log-derivative argument a la
Haboeck/LogUp).

Protocol: all checked chunk values v_i and the table multiplicities m_j
are COMMITTED wires (cs.commit -> Pedersen D in the proof); the verifier
recomputes the Fiat-Shamir challenge gamma = H(D); the circuit enforces

    sum_i 1/(gamma - v_i)  ==  sum_j m_j / (gamma - j),   j in [0, 2^tb)

which holds iff the multiset {v_i} is contained in the table with the
claimed multiplicities (Schwartz-Zippel over the random gamma).  Each
check costs ~2 constraints; the table side is a fixed ~3*2^tb.

Values wider than the table are split into tb-bit chunks (allocated +
recomposed); a value of nbits % tb != 0 also checks its top chunk shifted
to full width (v_top * 2^(tb - rem) must also be in the table).
"""

from __future__ import annotations

from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb


def batch_inverse(xs, p: int) -> list:
    """[pow(x, -1, p) for x in xs], xs reduced mod p, by one inversion and
    3(n - 1) products (Montgomery's trick): a committed prove's re-solve
    inverts one value per checked chunk and per table entry.  A zero
    raises pow's ValueError."""
    prefix = [1] * len(xs)
    acc = 1
    for i, x in enumerate(xs):
        prefix[i] = acc
        acc = acc * x % p
    inv = pow(acc, -1, p)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * xs[i] % p
    return out


class LookupRangeChecker:
    """Deferred range checks resolved against a [0, 2^table_bits) table at
    finalize().  One instance per ConstraintSystem; finalize() must run
    before proving (it places the commitment)."""

    def __init__(self, cs: ConstraintSystem, table_bits: int = 12):
        self.cs = cs
        self.tb = table_bits
        self._checked: list = []  # single-variable LinCombs
        self._finalized = False

    # -- public API ----------------------------------------------------------

    def range_check(self, v, nbits: int):
        """Assert 0 <= v < 2^nbits (deferred).  v: LinComb or int-coercible."""
        assert not self._finalized, "checker already finalized"
        cs, tb = self.cs, self.tb
        v = cs.coerce(v)
        if nbits == 0:
            cs.assert_zero(v)
            return
        full, rem = divmod(nbits, tb)
        chunks = []
        val = v.value
        for i in range(full + (1 if rem else 0)):
            c = cs.priv_input((val >> (tb * i)) & ((1 << tb) - 1))
            chunks.append(c)
            self._defer(c)
        if rem:
            # top chunk must fit rem bits: its shift into full width must
            # also be a table member
            shifted = chunks[-1] * (1 << (tb - rem))
            s_var = cs.priv_input(shifted.value)
            cs.assert_eq(shifted, s_var)
            self._defer(s_var)
        acc = cs.constant(0)
        for i, c in enumerate(chunks):
            acc = acc + c * (1 << (tb * i))
        cs.assert_eq(acc, v)

    def _defer(self, var: LinComb):
        self._checked.append(var)

    def finalize(self, challenge_value: int = 0, blind_value: int = 0):
        """Commit the checked values + multiplicities, obtain the challenge
        wire, and enforce the log-derivative identity.  Returns the
        challenge LinComb.  Call exactly once, at the end of the build;
        pass-through args come from Groth16.prove_committed's two-phase
        builder."""
        assert not self._finalized
        self._finalized = True
        cs, tb = self.cs, self.tb
        n_table = 1 << tb
        # gamma inside the table makes a denominator vanish; H(D) lands
        # there with probability 2^(tb - 253) (negligible), but a TEST
        # challenge must be chosen outside [0, 2^tb)
        assert challenge_value == 0 or challenge_value >= n_table, (
            "challenge collides with the lookup table range"
        )

        counts = [0] * n_table
        for v in self._checked:
            val = v.value
            assert 0 <= val < n_table, "deferred value out of table range"
            counts[val] += 1
        m_vars = [cs.priv_input(c) for c in counts]

        gamma = cs.commit(
            self._checked + m_vars, challenge_value, blind_value
        )
        # record the challenge-dependent wires so refinalize() can re-solve
        # them in place instead of rebuilding the whole circuit (the
        # second full Python build per committed prove was ~half the
        # host-side prove cost at c2 scale)
        self._gamma_idx = cs.challenge_idx
        self._inv_idx: list = []
        self._prod_idx: list = []

        # Accumulate the two sums with ONE dict pass: LinComb.__add__ copies
        # its dict, so a rolling `acc = acc + term` over ~1e5 inverses is
        # quadratic in builder time (the keccak wide-XOR pathology).
        def fast_sum(lincombs):
            t: dict = {}
            for lc in lincombs:
                for k, v in lc.terms.items():
                    t[k] = (t.get(k, 0) + v) % cs.p
            return LinComb(cs, {k: v for k, v in t.items() if v})

        def _inv(x):
            out = cs.inv(x)
            ((i, _),) = out.terms.items()
            self._inv_idx.append(i)
            return out

        def _mul(a, b):
            out = cs.mul(a, b)
            ((i, _),) = out.terms.items()
            self._prod_idx.append(i)
            return out

        # LHS: sum 1/(gamma - v_i); inv() pins gamma != v_i (negligible)
        lhs = fast_sum([_inv(gamma - v) for v in self._checked])
        # RHS: sum m_j / (gamma - j) — denominators are linear in gamma
        rhs = fast_sum(
            [_mul(m_vars[j], _inv(gamma - cs.constant(j))) for j in range(n_table)]
        )
        cs.assert_eq(lhs, rhs)
        self._m_idx = [list(m.terms)[0] for m in m_vars]
        return gamma

    def refinalize(self, challenge_value: int):
        """Re-solve the challenge-dependent wires in place for a new
        challenge — structure is challenge-independent, so the already-
        built system stays valid (Groth16.prove_committed's second phase
        without a second circuit build)."""
        assert self._finalized, "finalize() first"
        cs, p = self.cs, self.cs.p
        n_table = 1 << self.tb
        assert challenge_value == 0 or challenge_value >= n_table, (
            "challenge collides with the lookup table range"
        )
        g = challenge_value % p
        cs.values[self._gamma_idx] = g
        vals = [v.value for v in self._checked]
        invs = batch_inverse([(g - v) % p for v in vals]
                             + [(g - j) % p for j in range(n_table)], p)
        table_invs = invs[len(vals):]
        # finalize() allocation order: one inv per checked value, then per
        # table entry an inv and a product
        for idx, iv in zip(self._inv_idx[: len(vals)], invs):
            cs.values[idx] = iv
        for j in range(n_table):
            cs.values[self._inv_idx[len(vals) + j]] = table_invs[j]
            cs.values[self._prod_idx[j]] = (
                cs.values[self._m_idx[j]] * table_invs[j] % p
            )
