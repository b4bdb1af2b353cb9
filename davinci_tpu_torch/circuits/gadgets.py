"""In-circuit gadget library over the R1CS frontend.

Role parity: the gnark std-lib + vocdoni/gnark-crypto-primitives gadgets the
reference circuits compose (smt verifier, native twistededwards, Poseidon
multi-hash, comparators) — re-implemented for our frontend with classical
soundness arguments (canonical bit decompositions instead of gnark's
commitment-backed range checks).
"""

from __future__ import annotations

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.elgamal.bjj import A_RTE, D_RTE, GENERATOR
from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb
from davinci_tpu_torch.hash.poseidon import N_ROUNDS_P


# ---------------------------------------------------------------------------
# Hash helpers
# ---------------------------------------------------------------------------


def multi_poseidon_gadget(cs: ConstraintSystem, inputs: list) -> LinComb:
    """Chunk-of-16 Poseidon multihash (reference crypto/hash/poseidon)."""
    if len(inputs) <= 16:
        return cs.poseidon(inputs)
    hashes = [
        cs.poseidon(inputs[i : i + 16]) for i in range(0, len(inputs), 16)
    ]
    if len(hashes) == 1:
        return hashes[0]
    if len(hashes) <= 16:
        return cs.poseidon(hashes)
    return multi_poseidon_gadget(cs, hashes)


# ---------------------------------------------------------------------------
# Comparators / canonical decompositions
# ---------------------------------------------------------------------------


def assert_bits_lt_const(cs: ConstraintSystem, bits: list, bound: int):
    """Assert the little-endian boolean `bits` encode a value < bound.
    MSB-first scan: lt | (eq & bit<=bound_bit) chain."""
    n = len(bits)
    lt = cs.constant(0)  # already strictly less from higher bits
    for i in reversed(range(n)):
        b_i = (bound >> i) & 1
        bit = cs.coerce(bits[i])
        if b_i == 1:
            # if not yet lt and bit==0 -> lt
            lt = lt + cs.mul(cs.one - lt, cs.one - bit)
        else:
            # bit must be 0 unless already lt: (1-lt)*bit == 0
            cs.assert_mul(cs.one - lt, bit, cs.constant(0))
    # equality never sets lt, so a strict comparison requires lt == 1
    cs.assert_eq(lt, cs.one)


def to_bits_canonical(cs: ConstraintSystem, a, nbits: int) -> list:
    """Bit decomposition with uniqueness: value < min(2^nbits, p) enforced,
    so a malicious prover cannot present a + p."""
    bits = cs.to_bits(a, nbits)
    if (1 << nbits) > cs.p:
        assert_bits_lt_const(cs, bits, cs.p)
    return bits


# ---------------------------------------------------------------------------
# BabyJubJub (RTE, a = -1) native ops — BN254 Fr circuits only
# ---------------------------------------------------------------------------


def te_add(cs: ConstraintSystem, p1, p2):
    """Complete twisted Edwards addition in RTE form (a=-1):
    x3 = (x1 y2 + y1 x2)/(1 + d x1 x2 y1 y2),
    y3 = (y1 y2 + x1 x2)/(1 - d x1 x2 y1 y2)."""
    x1, y1 = p1
    x2, y2 = p2
    x1y2 = cs.mul(x1, y2)
    y1x2 = cs.mul(y1, x2)
    x1x2 = cs.mul(x1, x2)
    y1y2 = cs.mul(y1, y2)
    dxy = cs.mul(x1y2, y1x2) * D_RTE  # d * x1 x2 y1 y2
    x3 = cs.div(x1y2 + y1x2, cs.one + dxy)
    y3 = cs.div(y1y2 + x1x2, cs.one - dxy)
    return (x3, y3)


def te_select(cs: ConstraintSystem, cond, p1, p2):
    return (cs.select(cond, p1[0], p2[0]), cs.select(cond, p1[1], p2[1]))


def te_scalar_mul_bits(cs: ConstraintSystem, point, bits):
    """k*P from little-endian bits (double-and-add, identity-started —
    complete formulas make that safe)."""
    acc = (cs.constant(0), cs.constant(1))
    cur = point
    for i, b in enumerate(bits):
        added = te_add(cs, acc, cur)
        acc = te_select(cs, b, added, acc)
        if i + 1 < len(bits):
            cur = te_add(cs, cur, cur)
    return acc


def te_scalar_mul(cs: ConstraintSystem, point, scalar, nbits: int = 254):
    bits = to_bits_canonical(cs, scalar, nbits)
    return te_scalar_mul_bits(cs, point, bits)


def te_base_mul(cs: ConstraintSystem, scalar, nbits: int = 254):
    g = (cs.constant(GENERATOR.x), cs.constant(GENERATOR.y))
    return te_scalar_mul(cs, g, scalar, nbits)


def te_neg(cs: ConstraintSystem, p):
    return (cs.constant(0) - p[0], p[1])


# ---------------------------------------------------------------------------
# SMT verifier (inclusion, with precomputed leaf hash)
# ---------------------------------------------------------------------------


def smt_verify_inclusion(
    cs: ConstraintSystem,
    root,
    siblings: list,
    key,
    leaf_hash,
    n_levels: int | None = None,
):
    """Assert leaf_hash sits at `key` under `root` given padded siblings
    (reference circuits/merkleproof + circomlib smtverifier semantics).

    The leaf depth d is derived in-circuit from the deepest nonzero sibling
    (siblings beyond the leaf are zero by construction)."""
    n = n_levels if n_levels is not None else len(siblings)
    siblings = [cs.coerce(s) for s in siblings[:n]]
    key = cs.coerce(key)
    leaf_hash = cs.coerce(leaf_hash)
    root = cs.coerce(root)

    z = [cs.is_zero(s) for s in siblings]  # z[i]: sibling i is empty
    # suffix products S[i] = prod_{j >= i} z[j]; S[n] = 1
    S = [None] * (n + 1)
    S[n] = cs.one
    for i in reversed(range(n)):
        S[i] = cs.mul(S[i + 1], z[i])

    # state keys are uint64 by protocol; only the first n bits steer the path
    key_bits = cs.to_bits(key, 64)[:n]

    # walk bottom-up; child at step i is the leaf iff d == i+1
    cur = cs.constant(0)
    for i in reversed(range(n)):
        is_leaf_child = cs.mul(S[i + 1], cs.one - z[i])  # [d == i+1]
        child = cs.select(is_leaf_child, leaf_hash, cur)
        # parent = H(child, sib) or H(sib, child) by key bit i
        left = cs.select(key_bits[i], siblings[i], child)
        right = cs.select(key_bits[i], child, siblings[i])
        cur = cs.poseidon([left, right])
    # d == 0 (leaf is the root) iff all siblings empty
    claimed = cs.select(S[0], leaf_hash, cur)
    cs.assert_eq(claimed, root)


def smt_leaf_hash(cs: ConstraintSystem, key, value) -> LinComb:
    return cs.poseidon([cs.coerce(key), cs.coerce(value), cs.one])


def smt_encode_leaf_value(cs: ConstraintSystem, values: list) -> LinComb:
    if len(values) == 1:
        return cs.coerce(values[0])
    return multi_poseidon_gadget(cs, values)


# ---------------------------------------------------------------------------
# ElGamal decryption-proof verification (Chaum-Pedersen)
# ---------------------------------------------------------------------------


def verify_decryption_proof_gadget(
    cs: ConstraintSystem,
    pubkey,            # (x, y)
    c1,                # (x, y)
    c2,                # (x, y)
    msg,               # scalar
    a1,                # (x, y)
    a2,                # (x, y)
    z,                 # scalar response
    nbits: int = 254,
):
    """z*G == A1 + e*P and z*C1 == A2 + e*D, D = C2 - msg*G, with
    e = MultiPoseidon(P,P,C1,D,A1,A2) (reference crypto/elgamal/proof.go +
    gnark-crypto-primitives elgamal gadget)."""
    mg = te_base_mul(cs, msg, nbits)
    d_pt = te_add(cs, c2, te_neg(cs, mg))
    e = multi_poseidon_gadget(
        cs,
        [
            pubkey[0], pubkey[1], pubkey[0], pubkey[1],
            c1[0], c1[1], d_pt[0], d_pt[1],
            a1[0], a1[1], a2[0], a2[1],
        ],
    )
    e_bits = to_bits_canonical(cs, e, nbits)
    z_bits = to_bits_canonical(cs, z, nbits)

    zg = te_base_mul_bits(cs, z_bits)
    ep = te_scalar_mul_bits(cs, pubkey, e_bits)
    lhs1 = zg
    rhs1 = te_add(cs, a1, ep)
    cs.assert_eq(lhs1[0], rhs1[0])
    cs.assert_eq(lhs1[1], rhs1[1])

    zc1 = te_scalar_mul_bits(cs, c1, z_bits)
    ed = te_scalar_mul_bits(cs, d_pt, e_bits)
    rhs2 = te_add(cs, a2, ed)
    cs.assert_eq(zc1[0], rhs2[0])
    cs.assert_eq(zc1[1], rhs2[1])


def te_base_mul_bits(cs: ConstraintSystem, bits):
    g = (cs.constant(GENERATOR.x), cs.constant(GENERATOR.y))
    return te_scalar_mul_bits(cs, g, bits)
