"""In-circuit pairing + Groth16-verification gadgets for 12-tower curves
(BN254, BLS12-377), generic over the base-field ops provider:

  * NativeOps  -> the 2-chain case: BLS12-377 arithmetic inside a BW6-761
    circuit (native field equality BW6_761_R == BLS12_377_P) — the
    reference's aggregator recursion (circuits/aggregator/aggregator.go:
    18-56 verifying 60 BLS12-377 vote-verifier proofs);
  * EmulatedOps -> the emulated case: BN254 arithmetic inside a BLS12-377
    circuit — the reference's vote-verifier verifying the circuit-1 ballot
    proof (circuits/voteverifier/vote_verifier.go:71-87, gnark sw_bn254).

Design notes (TPU-agnostic, R1CS-cost-driven):
  * Affine Miller loop with slope inversions as hints (1 constraint each):
    in R1CS inversion is as cheap as multiplication, so affine formulas
    beat projective (same trade gnark makes).
  * Lines through CONSTANT G2 points (vk gamma/delta, and e(alpha,beta)'s
    whole Miller value) are precomputed on the host — only the variable
    proof points A, B, C generate in-circuit curve arithmetic.
  * The final exponentiation is replaced by an r-th-power residue witness:
    FE(f) == 1  <=>  exists c with c^r == f  (valid because r exactly
    divides p^12 - 1 once; asserted at construction).  One in-circuit
    exponentiation by the 253-bit constant r instead of the ~4500-bit
    (p^12-1)/r — the same family of tricks as "On Proving Pairings"
    (PAPERS.md), in its simplest sound form.
"""

from __future__ import annotations

from davinci_tpu_torch import curves as C
from davinci_tpu_torch.circuits.algebra import (
    CubicOps,
    NativeOps,
    QuadOps,
    WeierstrassGadget,
    aux_point,
)
from davinci_tpu_torch.circuits.emulated import EmulatedOps
from davinci_tpu_torch.towers import FF


class PairingGadget12:
    """Ate-pairing machinery for a 12-tower curve inside a circuit."""

    def __init__(self, cs, ctx, base_ops=None):
        """ctx: host PairingCtx (davinci_tpu_torch.pairing); base_ops: NativeOps
        (requires cs.p == ctx.p) or EmulatedOps over ctx.p."""
        assert ctx.twist_d_type, "M-type twists not wired yet (BLS12-381)"
        self.cs = cs
        self.ctx = ctx
        if base_ops is None:
            if cs.p == ctx.p:
                base_ops = NativeOps(cs)
            else:
                base_ops = EmulatedOps(cs, ctx.p)
        self.base = base_ops
        # tower ops mirroring the host tower shapes (towers.py), with
        # constant-multiplication fast paths for the nonresidues (free for
        # native ops; linear for emulated)
        nr2 = ctx.fp2.nr
        self.fp2 = QuadOps(
            base_ops,
            base_ops.constant(nr2),
            nr_mul=lambda a: base_ops.cmul(a, nr2),
        )
        xi0, xi1 = ctx.fp6.nr  # xi in Fp2 (raw pair)
        nr_xi1 = nr2 * xi1 % ctx.p

        def _xi_mul(a):
            B = base_ops
            c0 = B.add(B.cmul(a[0], xi0), B.cmul(a[1], nr_xi1))
            c1 = B.add(B.cmul(a[0], xi1), B.cmul(a[1], xi0))
            return (c0, c1)

        self.fp6 = CubicOps(self.fp2, self.fp2.constant(ctx.fp6.nr), nr_mul=_xi_mul)
        self.fp12 = QuadOps(
            self.fp6,
            self.fp6.constant(ctx.fp12.nr),
            nr_mul=self.fp6.mul_by_nonresidue,
        )
        self.g1 = WeierstrassGadget(base_ops, base_ops.constant(ctx.g1.b_ff.v))
        self.g2 = WeierstrassGadget(self.fp2, self.fp2.constant(ctx.g2.b_ff.v))
        # r-th-root final-exp witness validity: r || p^12 - 1
        self._cofactor = (ctx.p**12 - 1) // ctx.r
        assert self._cofactor % ctx.r != 0, "r^2 | p^12-1: residue trick invalid"
        self._r_inv_mod_cof = pow(ctx.r, -1, self._cofactor)

    # -- host <-> gadget embeddings -----------------------------------------

    def fp12_value(self, f) -> FF:
        return FF(self.ctx.fp12, self.fp12.value(f))

    def fp12_constant(self, f_host: FF):
        return self.fp12.constant(f_host.v)

    # -- sparse line elements ------------------------------------------------

    def _line_fp12(self, lam2, xt2, yt2, xp, yp):
        """Untwisted line value at P as a full Fp12 element:
        -yp + (lam*xp) w + (yt - lam*xt) w^3   (D-type twist).
        lam2/xt2/yt2: Fp2 elements (gadget); xp/yp: base elements."""
        f2, f6 = self.fp2, self.fp6
        B = self.base
        c0 = f2.from_base(B.neg(yp))  # coeff of 1
        c1 = f2.mul_base(lam2, xp)  # coeff of w
        c3 = f2.sub(yt2, f2.mul(lam2, xt2))  # coeff of v*w
        even = (c0, f2.zero, f2.zero)
        odd = (c1, c3, f2.zero)
        return (even, odd)

    def _const_line_fp12(self, lam2_v, xt2_v, yt2_v, xp, yp):
        """Line with constant G2 data (host Fp2 values) and variable P."""
        f2 = self.fp2
        B = self.base
        lam_c = f2.constant(lam2_v)
        c0 = f2.from_base(B.neg(yp))
        c1 = f2.mul_base(lam_c, xp)  # const * variable: 2 base muls
        # yt - lam*xt is a pure host constant
        h = self.ctx.fp2
        c3_v = (FF(h, yt2_v) - FF(h, lam2_v) * FF(h, xt2_v)).v
        c3 = f2.constant(c3_v)
        return ((c0, f2.zero, f2.zero), (c1, c3, f2.zero))

    # -- G2 affine steps (variable Q) ----------------------------------------

    def _g2_dbl_step(self, T):
        """Returns (lam2, T') for doubling."""
        f2 = self.fp2
        x, y = T
        lam = f2.mul(f2.smul(f2.square(x), 3), f2.inv(f2.smul(y, 2)))
        x3 = f2.sub(f2.square(lam), f2.smul(x, 2))
        y3 = f2.sub(f2.mul(lam, f2.sub(x, x3)), y)
        return lam, (x3, y3)

    def _g2_add_step(self, T, Q):
        f2 = self.fp2
        lam = f2.mul(f2.sub(Q[1], T[1]), f2.inv(f2.sub(Q[0], T[0])))
        x3 = f2.sub(f2.sub(f2.square(lam), T[0]), Q[0])
        y3 = f2.sub(f2.mul(lam, f2.sub(T[0], x3)), T[1])
        return lam, (x3, y3)

    # -- host-side schedule for constant Q -----------------------------------

    def _host_line_schedule(self, Q_host):
        """Run the Miller schedule on the host collecting per-step
        (lam2, xt2, yt2) Fp2 raw values; mirrors miller() in pairing.py
        exactly (twisted coordinates)."""
        h2 = self.ctx.fp2
        x, y = FF(h2, Q_host.x.v), FF(h2, Q_host.y.v)
        steps = []

        def dbl(t):
            tx, ty = t
            lam = (3 * (tx * tx)) * (2 * ty).inv()
            x3 = lam * lam - 2 * tx
            y3 = lam * (tx - x3) - ty
            steps.append(("dbl", lam.v, tx.v, ty.v))
            return (x3, y3)

        def add(t, q):
            tx, ty = t
            qx, qy = q
            lam = (qy - ty) * (qx - tx).inv()
            x3 = lam * lam - tx - qx
            y3 = lam * (tx - x3) - ty
            steps.append(("add", lam.v, tx.v, ty.v))
            return (x3, y3)

        t = (x, y)
        for b in bin(self.ctx.loop_count)[3:]:
            t = dbl(t)
            if b == "1":
                t = add(t, (x, y))
        if self.ctx.is_bn:
            q1 = self._host_frob_g2((x, y), 1)
            q2 = self._host_frob_g2((x, y), 2)
            nq2 = (q2[0], -q2[1])
            t = add(t, q1)
            t = add(t, nq2)
        return steps

    def _host_frob_g2(self, q, k: int):
        """Frobenius^k on twisted G2 coords: conj + constant scaling."""
        h2 = self.ctx.fp2
        cx, cy = self._frob_coeffs(k)
        x, y = q
        if k % 2 == 1:
            x = FF(h2, h2.conj(x.v))
            y = FF(h2, h2.conj(y.v))
        return (x * cx, y * cy)

    def _frob_coeffs(self, k: int):
        """Scaling constants for G2 frobenius in twisted coordinates:
        x -> conj^k(x) * w^(2(p^k-1)) ... computed via the host tower."""
        ctx = self.ctx
        h2 = ctx.fp2
        # w^(p^k - 1) lies in Fp2: w^2 = v, v^3 = xi  =>  w^6 = xi
        e = ctx.p**k - 1
        assert e % 6 == 0
        xi = FF(h2, ctx.fp6.nr)
        w6 = xi ** (e // 6)
        # x coeff: (w^(p^k-1))^2 ; y coeff: (w^(p^k-1))^3
        # w^(p^k-1) = xi^(e/6); squares/cubes stay in Fp2
        return (w6 ** 2, w6 ** 3)

    # -- Miller loop ----------------------------------------------------------

    def miller_pairs(self, pairs):
        """Product of Miller values for a list of pairs.

        Each pair is (P, Qdesc) with P a G1 gadget point (base coords) and
        Qdesc either ("const", host AffinePoint) or ("var", G2 gadget
        point).  Returns an fp12 gadget element equal to the product of
        host ctx.miller values (same schedule, same formulas)."""
        f12 = self.fp12
        work = []
        for P, (kind, Q) in pairs:
            if kind == "const":
                sched = self._host_line_schedule(Q)
                work.append({"P": P, "kind": kind, "sched": sched, "i": 0})
            else:
                work.append({"P": P, "kind": kind, "T": Q, "Q": Q})

        f = f12.one

        def emit(w, step_kind):
            P = w["P"]
            if w["kind"] == "const":
                k, lam_v, xt_v, yt_v = w["sched"][w["i"]]
                assert k == step_kind
                w["i"] += 1
                return self._const_line_fp12(lam_v, xt_v, yt_v, P[0], P[1])
            if step_kind == "dbl":
                lam, T2 = self._g2_dbl_step(w["T"])
            else:
                lam, T2 = self._g2_add_step(w["T"], w["_addq"])
            line = self._line_fp12(lam, w["T"][0], w["T"][1], P[0], P[1])
            w["T"] = T2
            return line

        bits = bin(self.ctx.loop_count)[3:]
        for bi, b in enumerate(bits):
            if bi > 0:
                f = f12.square(f)
            else:
                f = f12.one  # first square of 1 is 1
            for w in work:
                f = f12.mul(f, emit(w, "dbl"))
            if b == "1":
                for w in work:
                    if w["kind"] == "var":
                        w["_addq"] = w["Q"]
                    f = f12.mul(f, emit(w, "add"))
        if self.ctx.is_bn:
            for w in work:
                if w["kind"] == "var":
                    q1 = self._frob_g2_gadget(w["Q"], 1)
                    w["_addq"] = q1
                f = f12.mul(f, emit(w, "add"))
            for w in work:
                if w["kind"] == "var":
                    q2 = self._frob_g2_gadget(w["Q"], 2)
                    w["_addq"] = (q2[0], self.fp2.neg(q2[1]))
                f = f12.mul(f, emit(w, "add"))
        if self.ctx.loop_neg:
            # f^(p^6) (conjugation over Fp6) — free: negate the odd part
            f = (f[0], self.fp6.neg(f[1]))
        return f

    def _frob_g2_gadget(self, Q, k: int):
        f2 = self.fp2
        cx, cy = self._frob_coeffs(k)
        x, y = Q
        if k % 2 == 1:
            x = f2.conj(x)
            y = f2.conj(y)
        return (f2.mul(x, f2.constant(cx.v)), f2.mul(y, f2.constant(cy.v)))

    # -- final exponentiation check -------------------------------------------

    def assert_final_exp_is_one(self, f):
        """Assert f^((p^12-1)/r) == 1 via the r-th-power residue witness:
        hint c = f^(r^-1 mod cofactor), assert c^r == f in-circuit (~250
        cheap squarings — the same family of tricks as "On Proving
        Pairings"; exponents shorter than r cannot be complete here since
        any sound residue exponent must be a multiple of r)."""
        f_host = self.fp12_value(f)
        f12 = self.fp12
        c_host = f_host**self._r_inv_mod_cof
        assert (c_host ** self.ctx.r) == f_host, "pairing product != 1"
        c = f12.alloc(c_host.v)
        f12.inv(c)  # c != 0: rules out the degenerate c=0 -> f=0 case
        acc = self._pow_const(c, self.ctx.r)
        f12.assert_eq(acc, f)

    def _frobenius(self, f, k: int = 1):
        """f^(p^k) on the fp12 gadget: conjugate Fp2 coefficients (odd k)
        and scale each basis coefficient by a host constant:
        (v^i w^j)^(p^k) = v^i w^j * xi^((i*2 + j)(p^k - 1)/6)."""
        ctx = self.ctx
        h2 = ctx.fp2
        e = ctx.p**k - 1
        assert e % 6 == 0
        xi = FF(h2, ctx.fp6.nr)
        g = xi ** (e // 6)  # = w^(p^k - 1), lies in Fp2
        f2 = self.fp2
        (a0, a1, a2), (b0, b1, b2) = f
        coeffs = [(a0, 0), (a1, 2), (a2, 4), (b0, 1), (b1, 3), (b2, 5)]
        out = []
        for c, wpow in coeffs:
            if k % 2 == 1:
                c = f2.conj(c)
            scale = (g**wpow).v
            out.append(self._fp2_cmul_const(c, scale))
        return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))

    def _fp2_cmul_const(self, a, kv):
        """fp2 gadget element times a host Fp2 constant (x0, x1): linear."""
        B = self.base
        x0, x1 = kv
        nr2 = self.ctx.fp2.nr
        if x1 % self.ctx.p == 0:
            return (B.cmul(a[0], x0), B.cmul(a[1], x0))
        c0 = B.add(B.cmul(a[0], x0), B.cmul(a[1], nr2 * x1 % self.ctx.p))
        c1 = B.add(B.cmul(a[0], x1), B.cmul(a[1], x0))
        return (c0, c1)

    def _pow_const(self, c, e: int):
        f12 = self.fp12
        acc = None
        for b in bin(e)[2:]:
            if acc is not None:
                acc = f12.square(acc)
            if b == "1":
                acc = c if acc is None else f12.mul(acc, c)
        return acc if acc is not None else f12.one


class Groth16VerifierGadget:
    """Verify a Groth16 proof of an inner circuit, in-circuit.

    The inner verifying key is a CONSTANT (embedded in the circuit, like
    gnark recursion with fixed vk); proof points are witness variables;
    public inputs arrive as little-endian boolean bit lists (binding to
    upper-circuit values is the caller's job via to_bits /
    to_canonical_bits).

    Check: e(-A, B) * e(alpha,beta) * e(PI,gamma) * e(C,delta) == 1, with
    m(alpha,beta) folded in as a host-precomputed Miller constant."""

    def __init__(self, cs, ctx, vk, base_ops=None):
        self.pg = PairingGadget12(cs, ctx, base_ops)
        self.cs = cs
        self.ctx = ctx
        self.vk = vk
        self.nbits = ctx.r.bit_length()
        self._aux = aux_point(ctx.g1)
        self._m_ab = ctx.miller(vk.alpha_g1, vk.beta_g2)  # host constant

    def alloc_proof(self, proof):
        """Host Proof -> gadget points (with on-curve checks)."""
        pg = self.pg
        A = pg.g1.alloc_point(proof.a)
        C = pg.g1.alloc_point(proof.c)
        B = (pg.fp2.alloc(proof.b.x.v), pg.fp2.alloc(proof.b.y.v))
        pg.g1.assert_on_curve(A)
        pg.g1.assert_on_curve(C)
        pg.g2.assert_on_curve(B)
        return {"A": A, "B": B, "C": C}

    def scalar_bits_from_native(self, v):
        """Bind an upper-circuit native value (< inner r) as an inner public
        input: canonical bit decomposition + range check against r."""
        from davinci_tpu_torch.circuits.algebra import assert_bits_lt_const

        bits = self.cs.to_bits(self.cs.coerce(v), self.nbits)
        assert_bits_lt_const(self.cs, bits, self.ctx.r)
        return bits

    def public_input_msm(self, bit_lists):
        """PI = k0 + sum_i [s_i] k_i over the inner G1 (constants)."""
        ks = self.vk.k_pub_g1
        assert len(bit_lists) == len(ks) - 1, "public input count mismatch"
        if not bit_lists:
            return self.pg.g1.constant_point(ks[0])
        # fold k0 via an extra always-one scalar bit list of length 1:
        pi = self.pg.g1.msm_with_aux(bit_lists, ks[1:], self._aux, self.nbits)
        return self.pg.g1.add_unequal(pi, self.pg.g1.constant_point(ks[0]))

    def assert_valid(self, proof_vars, public_bit_lists):
        pg = self.pg
        A, B, C = proof_vars["A"], proof_vars["B"], proof_vars["C"]
        PI = self.public_input_msm(public_bit_lists)
        f = pg.miller_pairs(
            [
                (pg.g1.neg(A), ("var", B)),
                (PI, ("const", self.vk.gamma_g2)),
                (C, ("const", self.vk.delta_g2)),
            ]
        )
        f = pg.fp12.mul(f, pg.fp12_constant(self._m_ab))
        pg.assert_final_exp_is_one(f)

    # -- committed proofs (Groth16 Pedersen-commitment extension) ------------

    def alloc_committed_proof(self, proof):
        """Host CommittedProof -> gadget points incl. the commitment D and
        its proof-of-knowledge (gnark std/recursion groth16-with-commitment
        role)."""
        pv = self.alloc_proof(proof)
        pg = self.pg
        D = pg.g1.alloc_point(proof.d)
        pok = pg.g1.alloc_point(proof.pok)
        pg.g1.assert_on_curve(D)
        pg.g1.assert_on_curve(pok)
        pv["D"], pv["pok"] = D, pok
        return pv

    def challenge_bits(self, proof_vars):
        """Recompute the inner proof's Fiat-Shamir challenge in-circuit:
        c = Poseidon_fp(D.x, D.y) mod r — matching
        Groth16.commitment_challenge's recursion-curve hash.  NATIVE base
        ops only (the 2-chain aggregator case: the circuit's scalar field
        IS the inner curve's fp, so the Poseidon is a few hundred
        constraints).

        The h == q*r + c split is exact over the native field; q's width
        admits at most two integer representatives of h, so a malicious
        prover can pick between <= 2 challenge values — the lookup
        argument's Schwartz-Zippel soundness error at worst doubles
        (immaterial at ~2^-250)."""
        from davinci_tpu_torch.circuits.algebra import NativeOps

        assert isinstance(self.pg.base, NativeOps), (
            "challenge recomputation needs native base ops (2-chain)"
        )
        cs = self.cs
        Dx, Dy = proof_vars["D"]
        h = cs.poseidon([Dx, Dy])
        r = self.ctx.r
        qv, cv = divmod(h.value % cs.p, r)
        q = cs.priv_input(qv)
        c = cs.priv_input(cv)
        cs.assert_eq(h, q * r + c)
        cs.to_bits(q, cs.p.bit_length() - r.bit_length() + 1)
        return self.scalar_bits_from_native(c)

    def assert_valid_committed(self, proof_vars, public_bit_lists):
        """Verify a committed proof (host Groth16.verify_committed
        mirrored): the PoK pairing check pins D to the committed basis;
        the main check folds [H(D)] k_challenge + D into the public-input
        accumulation."""
        pg = self.pg
        vk = self.vk
        assert vk.k_challenge_g1 is not None and vk.eta_g2 is not None, (
            "inner VK carries no commitment extension"
        )
        pv = proof_vars
        # PoK: e(pok, G2) * e(-D, [eta] G2) == 1
        f = pg.miller_pairs(
            [
                (pv["pok"], ("const", self.ctx.g2.gen)),
                (pg.g1.neg(pv["D"]), ("const", vk.eta_g2)),
            ]
        )
        pg.assert_final_exp_is_one(f)
        # main equation with PI = k0 + sum [s_i] k_i + [H(D)] k_chal + D
        c_bits = self.challenge_bits(pv)
        ks = vk.k_pub_g1
        assert len(public_bit_lists) == len(ks) - 1, "public count mismatch"
        pi = pg.g1.msm_with_aux(
            list(public_bit_lists) + [c_bits],
            list(ks[1:]) + [vk.k_challenge_g1],
            self._aux,
            self.nbits,
        )
        pi = pg.g1.add_unequal(pi, pg.g1.constant_point(ks[0]))
        pi = pg.g1.add_unequal(pi, pv["D"])
        A, B, C = pv["A"], pv["B"], pv["C"]
        f = pg.miller_pairs(
            [
                (pg.g1.neg(A), ("var", B)),
                (pi, ("const", vk.gamma_g2)),
                (C, ("const", vk.delta_g2)),
            ]
        )
        f = pg.fp12.mul(f, pg.fp12_constant(self._m_ab))
        pg.assert_final_exp_is_one(f)
