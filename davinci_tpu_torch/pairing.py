"""Host-side pairings for BN254, BLS12-377, BLS12-381 (BW6-761 to follow).

Correctness-first design: G2 points are untwisted into E(Fp12) and the
Miller loop runs with generic affine line functions over Fp12; the final
exponentiation is a plain pow by (p^12-1)/r.  This is the *verification*
path (host, cold) — proving never touches pairings, so the clarity/speed
trade is deliberate.  Validated structurally by bilinearity +
non-degeneracy tests (tests/test_pairing.py).

Role parity: gnark-crypto's pairing packages used by groth16.Verify in the
reference (circuits/artifacts.go:543 ProveAndVerify; api ballot-proof
verification api/ballotproof_verifier.go).
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import curves as C
from davinci_tpu_torch import fields as F
from davinci_tpu_torch.curves import AffinePoint
from davinci_tpu_torch.towers import FF


@dataclass(eq=False)
class PairingCtx:
    name: str
    g1: object          # CurveSpec (coords in Fp)
    g2: object          # CurveSpec (coords in Fp2)
    fp12: object        # QuadExt over Fp6
    p: int
    r: int
    loop_count: int     # ate loop (positive)
    loop_neg: bool      # x < 0 (conjugate at the end)
    is_bn: bool         # BN curves need the two Frobenius line steps
    twist_d_type: bool  # D-type: psi(x,y) = (x w^2, y w^3); M-type: w^-2, w^-3

    def __post_init__(self):
        fp6 = self.fp12.base
        fp2 = fp6.base
        self.fp2 = fp2
        self.fp6 = fp6
        one2 = fp2.one_ff()
        zero2 = fp2.zero_ff()
        # w = (0, 1) over Fp6, i.e. Fp12 element (0_fp6, 1_fp6)
        self.w = FF(self.fp12, (fp6.zero_ff().v, fp6.one_ff().v))
        self.final_exp = (self.p**12 - 1) // self.r
        assert (self.p**12 - 1) % self.r == 0

    # -- embeddings ----------------------------------------------------------

    def _fp_to_12(self, x: int) -> FF:
        fp2 = self.fp2
        e2 = FF(fp2, (x % self.p, 0))
        return self._fp2_to_12(e2)

    def _fp2_to_12(self, x: FF) -> FF:
        fp6 = self.fp6
        z2 = fp6.base.zero_ff().v
        e6 = FF(fp6, (x.v, z2, z2))
        return FF(self.fp12, (e6.v, fp6.zero_ff().v))

    def _untwist(self, q: AffinePoint):
        """G2 (coords in Fp2) -> point on E over Fp12."""
        x12 = self._fp2_to_12(q.x)
        y12 = self._fp2_to_12(q.y)
        w2 = self.w * self.w
        w3 = w2 * self.w
        if self.twist_d_type:
            return (x12 * w2, y12 * w3)
        return (x12 * w2.inv(), y12 * w3.inv())

    def _g1_to_12(self, pt: AffinePoint):
        return (self._fp_to_12(pt.x.v), self._fp_to_12(pt.y.v))

    # -- Miller machinery ----------------------------------------------------

    def _line(self, t, q, p):
        """Evaluate the line through t and q (affine pairs over Fp12) at p.
        Returns (value, t+q)."""
        xt, yt = t
        xq, yq = q
        xp, yp = p
        if xt == xq and yt == yq:
            lam = (3 * (xt * xt)) * (2 * yt).inv()
        elif xt == xq:
            # vertical line
            x3 = self._ec_add(t, q)  # infinity
            return (xp - xt), None
        else:
            lam = (yq - yt) * (xq - xt).inv()
        val = lam * (xp - xt) - (yp - yt)
        x3 = lam * lam - xt - xq
        y3 = lam * (xt - x3) - yt
        return val, (x3, y3)

    def _ec_add(self, a, b):
        return None  # only reached for vertical lines (not used for our loops)

    def miller(self, P: AffinePoint, Q: AffinePoint) -> FF:
        p12_one = self.fp12.one_ff()
        q12 = self._untwist(Q)
        p_pt = self._g1_to_12(P)
        t = q12
        f = p12_one
        bits = bin(self.loop_count)[3:]  # skip MSB
        for b in bits:
            val, t = self._line(t, t, p_pt)
            f = f * f * val
            if b == "1":
                val, t = self._line(t, q12, p_pt)
                f = f * val
        if self.is_bn:
            # two extra steps with pi(Q) and -pi^2(Q)
            q1 = self._frobenius_pt(q12, 1)
            q2 = self._frobenius_pt(q12, 2)
            nq2 = (q2[0], -q2[1])
            val, t = self._line(t, q1, p_pt)
            f = f * val
            val, t = self._line(t, nq2, p_pt)
            f = f * val
        if self.loop_neg:
            f = FF(self.fp12, self.fp12.conj(f.v))  # f^(p^6) == 1/f post-exp
        return f

    def _frobenius_pt(self, pt, k: int):
        x, y = pt
        e = self.p**k
        return (x**e, y**e)

    def pair(self, P: AffinePoint, Q: AffinePoint) -> FF:
        """Full pairing e(P, Q); P on G1, Q on G2.  Identity inputs -> 1."""
        if P.infinity or Q.infinity:
            return self.fp12.one_ff()
        f = self.miller(P, Q)
        return f**self.final_exp

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1 — the Groth16 verification form."""
        acc = self.fp12.one_ff()
        for P, Q in pairs:
            if P.infinity or Q.infinity:
                continue
            acc = acc * self.miller(P, Q)
        return acc**self.final_exp == self.fp12.one_ff()


class BW6PairingCtx:
    """BW6-761: embedding degree 6, G1 AND G2 over Fp (sextic M-twist with
    xi = u^3 = -4), Fp6 = Fp3[v]/(v^2 - u), Fp3 = Fp[u]/(u^3 + 4).

    The pairing is the reduced TATE pairing e(P, Q) = f_{r,P}(psi(Q))^
    ((p^6-1)/r): the Miller function is built over G1 (coords in Fp —
    cheap host bignum steps), evaluated at the untwisted Q in Fp6;
    vertical-line denominators lie in the subfield Fp3 and are killed by
    the final exponentiation (standard denominator elimination), so only
    line numerators are multiplied.  Correctness-first host path — proving
    only needs MSM/NTT; this backs Groth16-over-BW6 *verification* for the
    aggregator circuit (reference circuits/aggregator compile.go:19-39,
    gnark-crypto bw6-761 role).
    """

    name = "bw6_761"

    def __init__(self, name=None, g1=None, g2=None, p=None, r=None,
                 fp3_nr=None, fp=None):
        """No-arg = BW6-761.  Explicit params build the same 6-tower
        pairing over any BW6-style curve (G1/G2 over Fp, sextic M-twist by
        the Fp3 nonresidue) — the toy outer curves of CI 2-chains
        (circuits/toycurve.toy_2chain)."""
        from davinci_tpu_torch.towers import CubicExt, QuadExt

        if name is not None:
            self.name = name
        self.g1 = g1 or C.bw6_g1
        self.g2 = g2 or C.bw6_g2
        self.p = p or F.BW6_761_P
        self.r = r or F.BW6_761_R
        fp = fp or (C.fp_bw6 if g1 is None else g1.fld)
        self.fp = fp
        # Fp3 = Fp[u]/(u^3 - nr); BW6-761: u^3 = -4
        self.fp3_nr = (-4 if fp3_nr is None else fp3_nr) % self.p
        self.fp3 = CubicExt(fp, fp(self.fp3_nr), f"{self.name}.fp3")
        self.fp6 = QuadExt(
            self.fp3, FF(self.fp3, (0, 1, 0)), f"{self.name}.fp6"
        )  # v^2 = u
        self.final_exp = (self.p**6 - 1) // self.r
        assert (self.p**6 - 1) % self.r == 0
        # untwist psi(x, y) = (x * w^-2, y * w^-3) for the M-type twist
        z3 = self.fp3.zero_ff().v
        w = FF(self.fp6, (z3, self.fp3.one_ff().v))
        self.w2_inv = (w * w).inv()
        self.w3_inv = (w * w * w).inv()
        # sanity: untwisted generator lands on E(Fp6): y^2 = x^3 + b
        gx, gy = self._untwist(self.g2.gen)
        b6 = self.fp6.from_int(self.g1.b_ff.v)
        assert gy * gy == gx * gx * gx + b6, "BW6 untwist inconsistent"

    def _untwist(self, q: AffinePoint):
        x6 = self.fp6.from_int(q.x.v) * self.w2_inv
        y6 = self.fp6.from_int(q.y.v) * self.w3_inv
        return (x6, y6)

    def miller(self, P: AffinePoint, Q: AffinePoint) -> FF:
        """f_{r,P} evaluated at psi(Q) (numerators only)."""
        p = self.p
        xq, yq = self._untwist(Q)
        one6 = self.fp6.one_ff()
        xt, yt = P.x.v, P.y.v
        xp, yp = P.x.v, P.y.v
        f = one6

        def line_eval(lam, xt, yt):
            # l(Q) = lam*(x_Q - x_T) - (y_Q - y_T)
            return (xq - self.fp6.from_int(xt)) * lam - (
                yq - self.fp6.from_int(yt)
            )

        bits = bin(self.r)[3:]
        t_inf = False
        for i, b in enumerate(bits):
            assert not t_inf
            # doubling step
            lam = 3 * xt * xt % p * pow(2 * yt % p, -1, p) % p
            f = f * f * line_eval(lam, xt, yt)
            x3 = (lam * lam - 2 * xt) % p
            y3 = (lam * (xt - x3) - yt) % p
            xt, yt = x3, y3
            if b == "1":
                if xt == xp and (yt + yp) % p == 0:
                    # T == -P: the final vertical line lies in the Fp3
                    # subfield — killed by the final exponentiation; skip.
                    t_inf = True
                    continue
                lam = (yp - yt) % p * pow((xp - xt) % p, -1, p) % p
                f = f * line_eval(lam, xt, yt)
                x3 = (lam * lam - xt - xp) % p
                y3 = (lam * (xt - x3) - yt) % p
                xt, yt = x3, y3
        return f

    def pair(self, P: AffinePoint, Q: AffinePoint) -> FF:
        if P.infinity or Q.infinity:
            return self.fp6.one_ff()
        return self.miller(P, Q) ** self.final_exp

    def pairing_check(self, pairs) -> bool:
        acc = self.fp6.one_ff()
        for P, Q in pairs:
            if P.infinity or Q.infinity:
                continue
            acc = acc * self.miller(P, Q)
        return acc**self.final_exp == self.fp6.one_ff()


bn254_pairing = PairingCtx(
    "bn254",
    C.bn254_g1,
    C.bn254_g2,
    C.fp12_bn254,
    F.BN254_P,
    F.BN254_R,
    loop_count=6 * F.BN254_X + 2,
    loop_neg=False,
    is_bn=True,
    twist_d_type=True,
)

bls377_pairing = PairingCtx(
    "bls12_377",
    C.bls377_g1,
    C.bls377_g2,
    C.fp12_bls377,
    F.BLS12_377_P,
    F.BLS12_377_R,
    loop_count=F.BLS12_377_X,
    loop_neg=False,
    is_bn=False,
    twist_d_type=True,
)

bls381_pairing = PairingCtx(
    "bls12_381",
    C.bls381_g1,
    C.bls381_g2,
    C.fp12_bls381,
    F.BLS12_381_P,
    F.BLS12_381_R,
    loop_count=-F.BLS12_381_X,
    loop_neg=True,
    is_bn=False,
    twist_d_type=False,
)

bw6_pairing = BW6PairingCtx()

PAIRINGS = {
    "bn254": bn254_pairing,
    "bls12_377": bls377_pairing,
    "bls12_381": bls381_pairing,
    "bw6_761": bw6_pairing,
}
