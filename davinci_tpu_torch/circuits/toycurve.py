"""Synthetic small pairing curves for CI-scale recursion tests.

The real recursion chain runs over BN254 / BLS12-377 / BW6-761; a full
emulated in-circuit pairing over those is tens of millions of constraints
— gated, not CI material.  This module derives a REAL BLS12-family curve
with a tiny parameter x (p ~ 64 bits, Miller loop ~ a dozen iterations),
so the exact same gadget code (EmulatedOps + PairingGadget12 +
Groth16VerifierGadget) runs end-to-end — real inner Groth16 proof,
emulated in-circuit verification, outer Groth16 proof — in seconds.

This mirrors the reference's use of small/dummy fixtures for circuit CI
(circuits/test/* inputs generators, voteverifier/dummy.go) while keeping
every code path identical to production.

Family (standard BLS12):
    r = x^4 - x^2 + 1,  p = (x-1)^2/3 * r + x,  t = x + 1,  loop = x.
Search criteria: x = 0 mod 128 (NTT 2-adicity >= 14), x = 1 mod 3,
p = 1 mod 6, p and r prime, r || p^12 - 1 (residue-witness final exp).
"""

from __future__ import annotations

import functools

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.curves import (
    AffinePoint,
    CurveSpec,
    _g2_curve,
    j0_candidate_orders,
    sqrt_ff,
)
from davinci_tpu_torch.pairing import PairingCtx
from davinci_tpu_torch.towers import FF, CubicExt, Fp, QuadExt


def _is_prime(n: int) -> bool:
    return F._is_prime(n)


def _find_x(start: int = 256) -> int:
    x = start
    while x % 384 != 256:  # x = 0 mod 128, x = 1 mod 3
        x += 1
    while True:
        r = x**4 - x**2 + 1
        p3 = (x - 1) ** 2 * r
        if p3 % 3 == 0:
            p = p3 // 3 + x
            if (
                p % 6 == 1
                and _is_prime(p)
                and _is_prime(r)
                and (p**12 - 1) % r == 0
                and ((p**12 - 1) // r) % r != 0
            ):
                return x
        x += 384


def _find_x_2chain(m: int = 13, start: int | None = None) -> int:
    """BLS12 parameter search for 2-chain inners: x = 1 mod 3*2^m gives
    2-adicity >= m for BOTH r-1 = x^2(x-1)(x+1) and p-1 = (x-1)((x-1)r/3+1)
    — p is the OUTER curve's scalar field, so Groth16 NTT domains must
    exist on both chain layers (mirrors BLS12-377's x = 1 mod 2^46 design,
    the reason BW6-761's Fr is NTT-friendly)."""
    step = 3 << m
    x = start or (step + 1)
    while True:
        r = x**4 - x**2 + 1
        p3 = (x - 1) ** 2 * r
        if p3 % 3 == 0:
            p = p3 // 3 + x
            if (
                p % 6 == 1
                and _is_prime(p)
                and _is_prime(r)
                and (p**12 - 1) % r == 0
                and ((p**12 - 1) // r) % r != 0
            ):
                return x
        x += step


@functools.cache
def toy_bls12():
    """Build the toy curve family: returns a dict with field specs, curve
    specs, pairing ctx, and a Groth16 factory."""
    return _build_bls12(_find_x(), "toy")


def _build_bls12(x: int, tag: str):
    r = x**4 - x**2 + 1
    p = (x - 1) ** 2 // 3 * r + x
    h1 = (x - 1) ** 2 // 3
    assert p + 1 - (x + 1) == h1 * r

    fp = Fp(p, f"{tag}.fp")
    # Fp2 nonresidue: smallest non-square
    nr = next(
        c
        for c in [-1, -2, -3, -5, 2, 3, 5, 7, -7, 11]
        if pow(c % p, (p - 1) // 2, p) != 1
    )
    fp2 = QuadExt(fp, fp(nr), f"{tag}.fp2")

    # xi in Fp2: non-square and non-cube (so v^3 - xi and w^2 - v give a
    # field tower), and the D-twist b/xi must hit a curve with r-order
    # points over Fp2.
    def _ok_xi(a, b):
        xi = FF(fp2, (a % p, b % p))
        e2 = p * p - 1
        if (xi ** (e2 // 2)) == fp2.one_ff():
            return None
        if e2 % 3 == 0 and (xi ** (e2 // 3)) == fp2.one_ff():
            return None
        return xi

    g1 = None
    for bb in range(1, 40):
        cand = CurveSpec(f"{tag}_g1", fp, None, fp(bb), r, h1)
        # order check by random sampling
        try:
            cand.validate(samples=1)
        except AssertionError:
            continue
        g1 = cand
        break
    assert g1 is not None, "toy G1 not found"

    xi = None
    g2 = None
    for a, b in [(0, 1), (1, 1), (2, 1), (1, 2), (3, 1), (1, 3), (5, 1)]:
        cand_xi = _ok_xi(a, b)
        if cand_xi is None:
            continue
        try:
            g2 = _g2_curve(f"{tag}_g2", fp2, None, cand_xi, g1.b_ff.v, p, r, True)
        except AssertionError:
            continue
        xi = cand_xi
        break
    assert g2 is not None, "toy G2 twist not found"

    fp6 = CubicExt(fp2, xi, f"{tag}.fp6")
    fp12 = QuadExt(fp6, fp6.from_base(fp2.zero_ff()), f"{tag}.fp12")
    fp12.nr = (fp2.zero_ff().v, fp2.one_ff().v, fp2.zero_ff().v)

    # device field specs (12-bit limb layout, generic)
    fr_spec = F.FieldSpec(f"{tag}_fr", r, -(-r.bit_length() // F.LIMB_BITS))
    fp_spec = F.FieldSpec(f"{tag}_fp", p, -(-p.bit_length() // F.LIMB_BITS))
    g1.field_spec = fp_spec
    g2.field_spec = fp_spec

    g1.gen = g1.find_generator()
    g2.gen = g2.find_generator()

    ctx = PairingCtx(
        f"{tag}_bls12", g1, g2, fp12, p, r,
        loop_count=x, loop_neg=False, is_bn=False, twist_d_type=True,
    )
    # sanity: bilinearity on the toy curve
    e1 = ctx.pair(g1.gen.mul(5), g2.gen.mul(7))
    e2 = ctx.pair(g1.gen, g2.gen) ** 35
    assert e1 == e2 and e1 != fp12.one_ff(), "toy pairing broken"

    return {
        "x": x, "p": p, "r": r,
        "fp": fp, "fp2": fp2, "fp6": fp6, "fp12": fp12,
        "g1": g1, "g2": g2, "ctx": ctx,
        "fr_spec": fr_spec, "fp_spec": fp_spec,
    }


def toy_groth16():
    """A Groth16 backend over the toy curve (device MSM/NTT included)."""
    from davinci_tpu_torch.groth16 import Groth16

    t = toy_bls12()
    return Groth16("toy_bls12", ctx=t["ctx"], fr=t["fr_spec"])


# ---------------------------------------------------------------------------
# Toy 2-chain: inner BLS12 + outer BW6-style curve (Cocks-Pinch k=6, D=3)
# ---------------------------------------------------------------------------


@functools.cache
def toy_2chain(m: int = 13):
    """A CI-scale mirror of the BLS12-377 / BW6-761 2-chain (reference
    circuits/aggregator/compile.go:19 + statetransition VerifyAggregatorProof
    :240): an inner BLS12 family curve plus an outer curve with
    r_outer = p_inner, embedding degree 6, CM discriminant -3, and the
    BW6 tower shape (G1 AND G2 over Fq, sextic M-twist by the Fp3
    nonresidue) — so PairingGadget6 / Groth16VerifierGadgetBW6 run their
    FULL production code path (full Miller loop, residue-witness final
    exp) at ~90-bit r in CI.

    Outer construction is Cocks-Pinch: q = (t^2 + 3y^2)/4 with
    t = z + 1, y = (t - 2)/sqrt(-3) mod r for a primitive 6th root of
    unity z, lifted until q is prime; then q = z mod r so r | q^2 - q + 1
    (embedding degree 6) and r | q + 1 - t (curve order)."""
    from davinci_tpu_torch.curves import _match_j0_curve
    from davinci_tpu_torch.pairing import BW6PairingCtx

    tag = f"toy2c{m}" if m != 13 else "toy2c"
    inner = None
    x0 = None
    while inner is None:
        x0 = _find_x_2chain(m, start=x0 + (3 << m) if x0 else None)
        try:
            inner = _build_bls12(x0, tag)
        except AssertionError:
            continue  # tower/twist search failed for this x; next one
    r = inner["p"]

    # primitive 6th root of unity mod r (r = 1 mod 6 by family design)
    z = None
    for a in range(2, 200):
        c = pow(a, (r - 1) // 6, r)
        if pow(c, 3, r) == r - 1 and pow(c, 2, r) != 1 and c != 1:
            z = c
            break
    assert z is not None, "no 6th root of unity mod r"
    s3 = (2 * z - 1) % r  # sqrt(-3): (2z-1)^2 = 4(z^2 - z) + 1 = -3 mod r
    assert s3 * s3 % r == (-3) % r
    t0 = (z + 1) % r
    y0 = (t0 - 2) * pow(s3, -1, r) % r

    q = t = None
    for b in range(4000):  # ~1/(3 ln q) of candidates survive; scan out
        for a in range(8):
            for ybase in (y0, r - y0):
                tc, yc = t0 + a * r, ybase + b * r
                if (tc * tc + 3 * yc * yc) % 4:
                    continue
                qc = (tc * tc + 3 * yc * yc) // 4
                if qc % 6 != 1 or not _is_prime(qc):
                    continue
                if (qc + 1 - tc) % r:
                    continue
                if ((qc**6 - 1) // r) % r == 0:
                    continue  # residue-witness final exp needs r || q^6-1
                q, t = qc, tc
                break
            if q is not None:
                break
        if q is not None:
            break
    assert q is not None, "Cocks-Pinch outer prime not found"

    tag6 = f"toy_bw6{m}" if m != 13 else "toy_bw6"
    fq = Fp(q, f"{tag6}.fp")
    fq_spec = F.FieldSpec(
        f"{tag6}_fp", q, -(-q.bit_length() // F.LIMB_BITS)
    )
    orders = j0_candidate_orders(q)
    r_orders = [n for n in orders if n % r == 0]
    assert len(r_orders) >= 2, "need two r-order j=0 twists"

    eq = q - 1

    def _nsnc(c):  # non-square AND non-cube mod q (q = 1 mod 6)
        c %= q
        return pow(c, eq // 2, q) != 1 and pow(c, eq // 3, q) != 1

    ctx6 = None
    nr_cands = [c for c in (-4, -1, -2, -3, 2, 3, 5, -5, 6, -6, 7, -7,
                            10, 11, -11, 13, -13) if _nsnc(c)]
    for nr in nr_cands:
        for bb in list(range(1, 30)) + [-c for c in range(1, 30)]:
            try:
                b1, n1 = _match_j0_curve(fq, q, r, [bb], r_orders)
            except AssertionError:
                continue
            # M-twist partner: b2 = b1 * nr (untwist by w, w^6 = nr, maps
            # E_{b*nr}(Fq) into E_b(Fq6))
            b2v = b1.v * (nr % q) % q
            try:
                b2, n2 = _match_j0_curve(
                    fq, q, r, [b2v], [n for n in r_orders if n != n1]
                )
            except AssertionError:
                continue
            g1 = CurveSpec(f"{tag6}_g1", fq, fq_spec, b1, r, n1 // r)
            g2 = CurveSpec(f"{tag6}_g2", fq, fq_spec, b2, r, n2 // r)
            g1.gen = g1.find_generator()
            g2.gen = g2.find_generator()
            try:
                cand = BW6PairingCtx(
                    name=tag6, g1=g1, g2=g2, p=q, r=r, fp3_nr=nr, fp=fq
                )
            except AssertionError:
                continue
            e1 = cand.pair(g1.gen.mul(5), g2.gen.mul(7))
            e2 = cand.pair(g1.gen, g2.gen) ** 35
            if e1 == e2 and e1 != cand.fp6.one_ff():
                ctx6 = cand
                break
        if ctx6 is not None:
            break
    assert ctx6 is not None, "toy BW6 twist pair not found"

    return {
        "inner": inner,
        "ctx6": ctx6,
        "q": q,
        "t": t,
        # the outer Groth16's scalar field IS the inner base field
        "outer_fr": inner["fp_spec"],
    }


def toy_2chain_groth16(m: int = 13):
    """(inner, outer) Groth16 backends over the toy 2-chain — the CI-scale
    (vote verifier on BLS12-377, aggregator on BW6-761) pair."""
    from davinci_tpu_torch.groth16 import Groth16

    t = toy_2chain(m)
    inner = Groth16(
        t["inner"]["ctx"].name, ctx=t["inner"]["ctx"], fr=t["inner"]["fr_spec"]
    )
    outer = Groth16(t["ctx6"].name, ctx=t["ctx6"], fr=t["outer_fr"])
    return inner, outer
