"""In-circuit BW6-761 pairing / Groth16-verify (embedding degree 6),
emulated over BN254 — the state-transition circuit's aggregator-proof
verification (reference circuits/statetransition VerifyAggregatorProof:240,
gnark sw_bw6761 role).

Mirrors the host BW6PairingCtx (pairing.py): reduced Tate pairing, Miller
chain over G1 (affine, emulated 761-bit Fp), lines evaluated at the
untwisted Q in Fp6 = Fp3[v]/(v^2-u), Fp3 = Fp[u]/(u^3+4); subfield
vertical denominators skipped; final exponentiation via the r-th-power
residue witness.

COST REALITY: with bit range checks one emulated 761-bit mul is ~3k
constraints, so the full 377-bit Miller loop lands in the tens of
millions; pass `range_checker` (circuits/lookup.LookupRangeChecker) to
route all range checks through the log-derivative lookup and cut each
mul to lookup-tier cost.  CI exercises the FULL loop over the toy 2-chain
outer curve (circuits/toycurve.toy_2chain — identical code, ~90-bit r);
the production BW6-761 instantiation is gated (scripts/fullsize_c4.py).
"""

from __future__ import annotations

from davinci_tpu_torch.circuits.algebra import (
    CubicOps,
    QuadOps,
    WeierstrassGadget,
    aux_point,
)
from davinci_tpu_torch.circuits.emulated import EmulatedOps
from davinci_tpu_torch.pairing import bw6_pairing
from davinci_tpu_torch.towers import FF


class PairingGadget6:
    def __init__(self, cs, ctx=None, base_ops=None,
                 loop_bits: int | None = None, range_checker=None):
        """ctx: host BW6PairingCtx (None = BW6-761; toy outer ctxs from
        circuits/toycurve run the identical gadget at CI scale).
        range_checker: optional LookupRangeChecker routed into the
        emulated base ops (the production path — bit range checks
        otherwise dominate at ~3k constraints per 761-bit mul)."""
        ctx = ctx or bw6_pairing
        self.cs = cs
        self.ctx = ctx
        if base_ops is None:
            if cs.p == ctx.p:
                from davinci_tpu_torch.circuits.algebra import NativeOps

                base_ops = NativeOps(cs)
            else:
                base_ops = EmulatedOps(
                    cs, ctx.p, range_checker=range_checker
                )
        base = base_ops
        self.base = base
        # Fp3 = Fp[u]/(u^3 - nr3): BW6-761 has nr3 = -4
        nr3 = ctx.fp3_nr % ctx.p
        self.fp3 = CubicOps(
            base, base.constant(nr3), nr_mul=lambda a: base.cmul(a, nr3)
        )
        # Fp6 = Fp3[v]/(v^2 - u): nonresidue u = (0,1,0)
        self.fp6 = QuadOps(
            self.fp3,
            self.fp3.constant((0, 1, 0)),
            nr_mul=self.fp3.mul_by_nonresidue,
        )
        self.g1 = WeierstrassGadget(base, base.constant(ctx.g1.b_ff.v))
        # the G2 curve is also over Fp (b' = 4)
        self.g2 = WeierstrassGadget(base, base.constant(ctx.g2.b_ff.v))
        # untwist constants psi(x, y) = (x * w^-2, y * w^-3) as host Fp6
        self._w2_inv = ctx.w2_inv  # host FF in ctx.fp6
        self._w3_inv = ctx.w3_inv
        self.loop_bits = loop_bits  # None = full r (production)
        self._cofactor = (ctx.p**6 - 1) // ctx.r
        assert self._cofactor % ctx.r != 0
        self._r_inv_mod_cof = pow(ctx.r, -1, self._cofactor)

    # -- embeddings ----------------------------------------------------------

    def fp6_value(self, f) -> FF:
        return FF(self.ctx.fp6, self.fp6.value(f))

    def _untwist_var(self, Q):
        """Gadget G2 point (base coords) -> Fp6 gadget coords: multiply by
        the constant untwist factors (linear)."""
        xq = self._scale_by_const_fp6(Q[0], self._w2_inv.v)
        yq = self._scale_by_const_fp6(Q[1], self._w3_inv.v)
        return (xq, yq)

    def _untwist_const(self, Q_host):
        """Host G2 AffinePoint -> constant Fp6 gadget coords."""
        x6, y6 = self.ctx._untwist(Q_host)
        return (self.fp6.constant(x6.v), self.fp6.constant(y6.v))

    def _scale_by_const_fp6(self, a, c6v):
        """base element * host-Fp6-constant -> fp6 gadget element."""
        B = self.base
        out = []
        for tri in c6v:  # two Fp3 halves
            comp = []
            for c in tri:
                comp.append(B.cmul(a, c))
            out.append(tuple(comp))
        return tuple(out)

    def _fp6_from_base(self, a):
        return self.fp6.from_base(self.fp3.from_base(a))

    # -- Miller (Tate: chain over G1, eval at untwisted Q) -------------------

    def miller_pairs(self, pairs):
        """Product of (truncated) Tate Miller values.  pairs: list of
        (P, Qdesc) with P a gadget G1 point and Qdesc ("const", host
        AffinePoint) or ("var", gadget G2 point).  Matches the host
        BW6PairingCtx.miller with the same loop length."""
        f6, base = self.fp6, self.base
        loop = self.ctx.r
        if self.loop_bits is not None:
            loop = loop >> (self.ctx.r.bit_length() - self.loop_bits)
        work = []
        for P, (kind, Q) in pairs:
            q6 = (
                self._untwist_const(Q)
                if kind == "const"
                else self._untwist_var(Q)
            )
            work.append({"P": P, "T": P, "q6": q6})

        f = f6.one
        bits = bin(loop)[3:]
        for bi, b in enumerate(bits):
            if bi > 0:
                f = f6.square(f)
            for w in work:
                lam, T2 = self._g1_dbl(w["T"])
                f = f6.mul(f, self._line_eval(lam, w["T"], w["q6"]))
                w["T"] = T2
            if b == "1":
                if self.loop_bits is None and bi == len(bits) - 1:
                    # full loop: the final add step ALWAYS has T = (r-1)P
                    # = -P, a vertical line in the Fp3 subfield — killed
                    # by the final exponentiation; skip it exactly like
                    # the host (BW6PairingCtx.miller t_inf path).  k = r-1
                    # cannot arise at any earlier add step (bit prefixes
                    # of r are < r-1), so only this position degenerates.
                    continue
                for w in work:
                    # truncated loops: T == -P does not arise
                    lam, T2 = self._g1_add(w["T"], w["P"])
                    f = f6.mul(f, self._line_eval(lam, w["T"], w["q6"]))
                    w["T"] = T2
        return f

    def _g1_dbl(self, T):
        B = self.base
        x, y = T
        lam = B.mul(B.smul(B.square(x), 3), B.inv(B.smul(y, 2)))
        x3 = B.sub(B.square(lam), B.smul(x, 2))
        y3 = B.sub(B.mul(lam, B.sub(x, x3)), y)
        return lam, (x3, y3)

    def _g1_add(self, T, P):
        B = self.base
        lam = B.mul(B.sub(P[1], T[1]), B.inv(B.sub(P[0], T[0])))
        x3 = B.sub(B.sub(B.square(lam), T[0]), P[0])
        y3 = B.sub(B.mul(lam, B.sub(T[0], x3)), T[1])
        return lam, (x3, y3)

    def _line_eval(self, lam, T, q6):
        """l(Q) = lam*(x_Q - x_T) - (y_Q - y_T), all in Fp6; x_T, y_T, lam
        are base elements, Q components are fp6 gadget elements."""
        f6 = self.fp6
        xt6 = self._fp6_from_base(T[0])
        yt6 = self._fp6_from_base(T[1])
        lam6 = self._fp6_from_base(lam)
        return f6.sub(f6.mul(f6.sub(q6[0], xt6), lam6), f6.sub(q6[1], yt6))

    # -- final exponentiation check ------------------------------------------

    def assert_final_exp_is_one(self, f):
        f_host = self.fp6_value(f)
        c_host = f_host**self._r_inv_mod_cof
        assert (c_host ** self.ctx.r) == f_host, "pairing product != 1"
        c = self.fp6.alloc(c_host.v)
        self.fp6.inv(c)  # nonzero guard
        acc = None
        for b in bin(self.ctx.r)[2:]:
            if acc is not None:
                acc = self.fp6.square(acc)
            if b == "1":
                acc = c if acc is None else self.fp6.mul(acc, c)
        self.fp6.assert_eq(acc, f)


class Groth16VerifierGadgetBW6:
    """Verify a BW6-761 Groth16 proof (the aggregator's) inside a BN254
    circuit.  Public-input scalars arrive as boolean bit lists."""

    def __init__(self, cs, vk, ctx=None, loop_bits: int | None = None,
                 range_checker=None):
        self.pg = PairingGadget6(
            cs, ctx=ctx, loop_bits=loop_bits, range_checker=range_checker
        )
        self.cs = cs
        self.vk = vk
        self.nbits = self.pg.ctx.r.bit_length()
        self._aux = aux_point(self.pg.ctx.g1, "davinci-bw6-aux")
        self._m_ab = None  # miller(alpha, beta) — host const, full loop only
        if loop_bits is None:
            self._m_ab = self.pg.ctx.miller(vk.alpha_g1, vk.beta_g2)

    def alloc_proof(self, proof):
        pg = self.pg
        A = pg.g1.alloc_point(proof.a)
        C = pg.g1.alloc_point(proof.c)
        B = pg.g2.alloc_point(proof.b)
        pg.g1.assert_on_curve(A)
        pg.g1.assert_on_curve(C)
        pg.g2.assert_on_curve(B)
        return {"A": A, "B": B, "C": C}

    def public_input_msm(self, bit_lists):
        ks = self.vk.k_pub_g1
        assert len(bit_lists) == len(ks) - 1
        padded = [
            list(b) + [self.cs.constant(0)] * (self.nbits - len(b))
            for b in bit_lists
        ]
        pi = self.pg.g1.msm_with_aux(padded, ks[1:], self._aux, self.nbits)
        return self.pg.g1.add_unequal(pi, self.pg.g1.constant_point(ks[0]))

    def assert_valid(self, proof_vars, public_bit_lists):
        pg = self.pg
        assert pg.loop_bits is None, "full Miller loop required for soundness"
        A, B, C = proof_vars["A"], proof_vars["B"], proof_vars["C"]
        PI = self.public_input_msm(public_bit_lists)
        f = pg.miller_pairs(
            [
                (pg.g1.neg(A), ("var", B)),
                (PI, ("const", self.vk.gamma_g2)),
                (C, ("const", self.vk.delta_g2)),
            ]
        )
        f = pg.fp6.mul(f, pg.fp6.constant(self._m_ab.v))
        pg.assert_final_exp_is_one(f)
