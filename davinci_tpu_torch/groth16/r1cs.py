"""Rank-1 constraint system frontend with inline witness computation.

Role parity: the gnark frontend (`frontend.Compile`, `Define()` circuits)
used by every circuit in the reference (circuits/*/): our circuits are
Python functions over a ConstraintSystem; running one both records the
constraint structure and computes the witness (hints execute inline as
host bignum code, mirroring gnark's hint system).

The matrices export to the device prover as sparse COO (rows of (coeff,
var)); witness vectors export as int lists ordered [1, publics, privates].
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LinComb:
    """Sparse linear combination over witness variables: {var_idx: coeff}."""

    cs: "ConstraintSystem"
    terms: dict

    def __add__(self, o):
        o = self.cs.coerce(o)
        t = dict(self.terms)
        for k, v in o.terms.items():
            t[k] = (t.get(k, 0) + v) % self.cs.p
        return LinComb(self.cs, {k: v for k, v in t.items() if v})

    def __sub__(self, o):
        o = self.cs.coerce(o)
        return self + (o * (self.cs.p - 1))

    def __mul__(self, k):
        if isinstance(k, LinComb):
            return self.cs.mul(self, k)
        k = k % self.cs.p
        return LinComb(self.cs, {i: c * k % self.cs.p for i, c in self.terms.items() if c * k % self.cs.p})

    __rmul__ = __mul__

    def __neg__(self):
        return self * (self.cs.p - 1)

    @property
    def value(self) -> int:
        return (
            sum(c * self.cs.values[i] for i, c in self.terms.items()) % self.cs.p
        )

    def is_constant(self):
        return all(i == 0 for i in self.terms)


def check_satisfied_flat(mats, p: int, n_cons: int, values,
                         block: int = 1 << 20) -> bool:
    """Chunked satisfaction check over CSR matrices: evaluates constraint
    rows in `block`-sized slices so peak memory stays bounded (the
    all-at-once object-array product OOM-killed the 31.6M-constraint
    full-size circuit-4 check at ~100 GB)."""
    import numpy as np

    zv = np.empty(len(values), object)
    zv[:] = values
    for lo in range(0, n_cons, block):
        hi = min(lo + block, n_cons)
        vals = []
        for idx, coeff, offs in mats:
            s, e = int(offs[lo]), int(offs[hi])
            if e == s:
                vals.append(np.zeros(hi - lo, object))
                continue
            prod = coeff[s:e] * zv[idx[s:e]]
            prod = np.append(prod, 0)
            starts = np.minimum(offs[lo:hi] - s, len(prod) - 1)
            rows = np.add.reduceat(prod, starts)
            empty = offs[lo + 1 : hi + 1] == offs[lo:hi]
            if empty.any():
                rows[empty] = 0
            vals.append(rows % p)
        a, b, c = vals
        if bool((((a * b - c) % p) != 0).any()):
            return False
    return True


def matvec_flat(mats, p: int, n_cons: int, z, N: int):
    """(A z, B z, C z) mod p from CSR-exported matrices (see
    ConstraintSystem._flat_matrices) — shared by the live builder and the
    serialized solved-system loader (groth16/serialize.py)."""
    import numpy as np

    zv = np.empty(len(z), object)
    zv[:] = z
    out = []
    for idx, coeff, offs in mats:
        vec = [0] * N
        if len(idx):
            prod = coeff * zv[idx]
            prod = np.append(prod, 0)  # sentinel for trailing empty rows
            starts = np.minimum(offs[:-1], len(prod) - 1)
            rows = np.add.reduceat(prod, starts)
            empty = offs[1:] == offs[:-1]
            if empty.any():
                rows[empty] = 0
            rows = rows % p
            vec[:n_cons] = rows.tolist()
        out.append(vec)
    return out


class ConstraintSystem:
    """R1CS builder + witness evaluator (single pass).

    Variables: index 0 is the constant ONE; publics come first, then
    privates.  Construction order must be: all public inputs first (matches
    Groth16 vk layout), then arbitrary circuit logic.
    """

    def __init__(self, p: int):
        self.p = p
        self.values = [1]
        self.num_public = 0  # excluding ONE
        self.constraints = []  # list of (A_terms, B_terms, C_terms) dicts
        self._public_done = False
        self._labels: dict[int, str] = {}
        self._scope: list[str] = []
        self._flat = None  # cached CSR export (see _flat_matrices)
        self._flat_n = -1
        # Groth16 commitment extension (gnark `api.Commit` role): variable
        # indices whose values are exposed through a Pedersen commitment D
        # (gamma basis) instead of the private (delta) basis, plus the
        # Fiat-Shamir challenge wire the verifier recomputes as H(D).
        self.committed: list[int] = []
        self.challenge_idx: int | None = None
        self.challenge_fn = None  # host hint: list[int] values -> int

    # -- debug scopes (reference prover/debug role: localize unsat) ----------

    def scope(self, name: str):
        cs = self

        class _Scope:
            def __enter__(self_inner):
                cs._scope.append(name)

            def __exit__(self_inner, *a):
                cs._scope.pop()

        return _Scope()

    def _label_current(self):
        if self._scope:
            self._labels[len(self.constraints) - 1] = "/".join(self._scope)

    # -- variable creation --------------------------------------------------

    @property
    def one(self) -> LinComb:
        return LinComb(self, {0: 1})

    def constant(self, v: int) -> LinComb:
        return LinComb(self, {0: v % self.p} if v % self.p else {})

    def pub_input(self, value: int) -> LinComb:
        assert not self._public_done, "public inputs must be allocated first"
        assert len(self.values) == 1 + self.num_public
        self.values.append(value % self.p)
        self.num_public += 1
        return LinComb(self, {len(self.values) - 1: 1})

    def priv_input(self, value: int) -> LinComb:
        self._public_done = True
        self.values.append(value % self.p)
        return LinComb(self, {len(self.values) - 1: 1})

    def coerce(self, x) -> LinComb:
        if isinstance(x, LinComb):
            return x
        return self.constant(int(x))

    def commit(
        self, vars: list, challenge_value: int = 0, blind_value: int = 0
    ) -> LinComb:
        """Mark single-variable LinCombs as COMMITTED (gamma-basis, exposed
        through the Pedersen commitment D in the proof) and return the
        Fiat-Shamir challenge wire — gnark api.Commit role.

        The challenge's true value is H(D), which depends on the proving
        key, so circuits using commit() are built through a two-phase
        builder: Groth16.prove_committed calls the circuit builder once
        with (0, blind) to learn the committed values, computes D and
        H(D), then rebuilds with the real challenge (structure is
        witness-independent, so both builds share the proving key).  A
        blinding wire is appended to the committed set automatically."""
        assert self.challenge_idx is None, "one commitment per system"
        idxs = []
        for v in vars:
            assert isinstance(v, LinComb) and len(v.terms) == 1, (
                "committed wires must be plain variables"
            )
            ((i, c),) = v.terms.items()
            assert c == 1 and i != 0, "committed wires must be unscaled vars"
            idxs.append(i)
        blind = self.priv_input(blind_value)
        ((blind_idx, _),) = blind.terms.items()
        self.committed = idxs + [blind_idx]
        chal = self.priv_input(challenge_value % self.p)
        ((self.challenge_idx, _),) = chal.terms.items()
        return chal

    # -- constraints ---------------------------------------------------------

    def raw_constrain(self, a: LinComb, b: LinComb, c: LinComb):
        """a * b == c."""
        self.constraints.append((dict(a.terms), dict(b.terms), dict(c.terms)))
        self._label_current()

    def mul(self, a, b) -> LinComb:
        a, b = self.coerce(a), self.coerce(b)
        if a.is_constant():
            return b * a.value
        if b.is_constant():
            return a * b.value
        z = self.priv_input(a.value * b.value % self.p)
        self.raw_constrain(a, b, z)
        return z

    def assert_eq(self, a, b):
        a, b = self.coerce(a), self.coerce(b)
        self.raw_constrain(a, self.one, b)

    def assert_zero(self, a):
        self.assert_eq(a, self.constant(0))

    def assert_bool(self, a):
        a = self.coerce(a)
        self.raw_constrain(a, a - self.one, self.constant(0))

    def assert_mul(self, a, b, c):
        """a * b == c as one constraint (no aux variable)."""
        self.raw_constrain(self.coerce(a), self.coerce(b), self.coerce(c))

    # -- gadgets --------------------------------------------------------------

    def inv(self, a) -> LinComb:
        """1/a with a != 0 enforced."""
        a = self.coerce(a)
        v = pow(a.value, -1, self.p) if a.value else 0
        ainv = self.priv_input(v)
        self.raw_constrain(a, ainv, self.one)
        return ainv

    def div(self, a, b) -> LinComb:
        return self.mul(a, self.inv(b))

    def is_zero(self, a) -> LinComb:
        """1 if a == 0 else 0 (gnark-style: via inverse hint)."""
        a = self.coerce(a)
        v = a.value
        invv = pow(v, -1, self.p) if v else 0
        m = self.priv_input(invv)
        out = self.priv_input(1 if v == 0 else 0)
        # out = 1 - a*m ; a*out = 0
        self.raw_constrain(a, m, self.one - out)
        self.raw_constrain(a, out, self.constant(0))
        self.assert_bool(out)
        return out

    def select(self, cond, a, b) -> LinComb:
        """cond ? a : b (cond boolean)."""
        cond, a, b = self.coerce(cond), self.coerce(a), self.coerce(b)
        # out = b + cond*(a-b)
        d = self.mul(cond, a - b)
        return b + d

    def to_bits(self, a, nbits: int) -> list:
        """Little-endian bit decomposition with recomposition constraint.
        NOTE: for nbits close to the field size callers must ensure
        canonical decomposition separately."""
        a = self.coerce(a)
        v = a.value
        bits = []
        for i in range(nbits):
            bits.append(self.priv_input((v >> i) & 1))
            self.assert_bool(bits[-1])
        acc = self.constant(0)
        for i, b in enumerate(bits):
            acc = acc + b * (1 << i)
        self.assert_eq(acc, a)
        return bits

    def from_bits(self, bits) -> LinComb:
        acc = self.constant(0)
        for i, b in enumerate(bits):
            acc = acc + self.coerce(b) * (1 << i)
        return acc

    def assert_lt_const(self, a, bound: int, nbits: int):
        """a < bound via bit decomposition of (a) and (bound-1-a)."""
        a = self.coerce(a)
        self.to_bits(a, nbits)
        self.to_bits(self.constant(bound - 1) - a, nbits)

    def poseidon(self, inputs: list) -> LinComb:
        """In-circuit circomlib Poseidon over BN254 Fr (arity 1..16)."""
        from davinci_tpu_torch.hash.poseidon import (
            N_ROUNDS_P,
            R_F,
            poseidon_constants,
        )

        t = len(inputs) + 1
        assert 1 <= len(inputs) <= 16
        Cc, M = poseidon_constants(t, self.p)
        r_p = N_ROUNDS_P[t - 2]
        half = R_F // 2
        state = [self.constant(0)] + [self.coerce(x) for x in inputs]
        ctr = 0

        def sbox5(x):
            x2 = self.mul(x, x)
            x4 = self.mul(x2, x2)
            return self.mul(x4, x)

        def mix(s):
            return [
                sum(
                    (s[j] * M[i][j] for j in range(t)),
                    self.constant(0),
                )
                for i in range(t)
            ]

        for r in range(R_F + r_p):
            state = [state[i] + Cc[ctr + i] for i in range(t)]
            ctr += t
            is_full = r < half or r >= half + r_p
            if is_full:
                state = [sbox5(x) for x in state]
            else:
                state = [sbox5(state[0])] + state[1:]
            state = mix(state)
        return state[0]

    # -- export ----------------------------------------------------------------

    def _flat_matrices(self):
        """CSR export of (A, B, C): per matrix (idx int64 array, coeff object
        array, row-start offsets).  Cached; invalidated by growth."""
        import numpy as np

        if self._flat is not None and self._flat_n == len(self.constraints):
            return self._flat
        mats = []
        for sel in range(3):
            idxs: list = []
            coeffs: list = []
            offs = [0]
            for cons in self.constraints:
                t = cons[sel]
                idxs.extend(t.keys())
                coeffs.extend(t.values())
                offs.append(len(idxs))
            ca = np.empty(len(coeffs), object)
            ca[:] = coeffs
            mats.append(
                (
                    np.asarray(idxs, np.int64),
                    ca,
                    np.asarray(offs, np.int64),
                )
            )
        self._flat = tuple(mats)
        self._flat_n = len(self.constraints)
        return self._flat

    def matvec_all(self, z, N: int):
        """(A z, B z, C z) mod p as three length-N lists — the Groth16
        witness reduction, vectorized with numpy object arrays (the role of
        gnark's solver evaluation; reference prover hot loop SURVEY §3.2)."""
        return matvec_flat(
            self._flat_matrices(), self.p, len(self.constraints), z, N
        )

    @property
    def num_variables(self) -> int:
        return len(self.values)

    def witness(self) -> list:
        return list(self.values)

    def public_values(self) -> list:
        return self.values[1 : 1 + self.num_public]

    def check_satisfied(self) -> bool:
        n = len(self.constraints)
        if n > 20000:
            # vectorized chunked path for big systems (bounded memory)
            return check_satisfied_flat(
                self._flat_matrices(), self.p, n, self.values
            )
        return self.first_unsatisfied() is None

    def first_unsatisfied(self):
        """Index (+ scope label if any) of the first violated constraint —
        the reference's debug-prover role (prover/debug/debug.go:27
        NewDebugProver runs test.IsSolved to localize unsat constraints)."""
        for idx, (A, B, C) in enumerate(self.constraints):
            av = sum(c * self.values[i] for i, c in A.items()) % self.p
            bv = sum(c * self.values[i] for i, c in B.items()) % self.p
            cv = sum(c * self.values[i] for i, c in C.items()) % self.p
            if av * bv % self.p != cv:
                return idx, self._labels.get(idx, "")
        return None
