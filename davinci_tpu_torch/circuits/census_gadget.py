"""In-circuit census eligibility for the state-transition circuit:
LeanIMT Merkle inclusion and CSP EdDSA-BabyJubJub certificate checks.

Role parity: reference circuits/statetransition/statetransition.go
`VerifyMerkleCensusProofs` (:495-515) / `VerifyCSPCensusProofs` (:517-534),
over census/imt (LeanIMT) and crypto/csp/eddsa.  Both are switched by the
process census origin and only ASSERTED for real votes under the matching
origin — the gadgets compute unconditionally (uniform circuit structure)
and the caller masks the final equalities.

LeanIMT semantics (davinci_tpu_torch/census.py LeanIMT): a node with a single
child is promoted unhashed to the parent level, and a promoted node is
always a LEFT child — so inactive proof levels force index bit 0, which
makes `index = sum bit_i 2^i` exact and lets the circuit bind
ballot_index = BALLOT_MIN + leaf_index (reference BallotIndex, :536-544).
"""

from __future__ import annotations

from davinci_tpu_torch import fields as F
from davinci_tpu_torch import spec as protocol
from davinci_tpu_torch.circuits.gadgets import (
    te_add,
    te_scalar_mul_bits,
    to_bits_canonical,
    assert_bits_lt_const,
)
from davinci_tpu_torch.elgamal.bjj import SCALING_F, te_to_rte
from davinci_tpu_torch.curves import babyjubjub as _bjj

BASE8_RTE = te_to_rte(_bjj.base8)
EDDSA_ORDER = F.BABYJUBJUB_L


def is_merkle_origin(cs, origin):
    """1 iff origin is one of the three MerkleTree census origins
    (reference census/gnark.go IsMerkleTreeCensusOrigin:14-22)."""
    acc = cs.constant(0)
    for o in protocol.MERKLE_CENSUS_ORIGINS:
        acc = acc + cs.is_zero(origin - cs.constant(o))
    # origins are distinct, so at most one term fires; acc is boolean
    return acc


def is_csp_origin(cs, origin):
    """1 iff origin is CSPEdDSABabyJubJubV1 (census/gnark.go:28-30)."""
    return cs.is_zero(origin - cs.constant(protocol.CENSUS_ORIGIN_CSP_EDDSA_BJJ))


def pack_census_leaf_gadget(cs, addr, weight):
    """leaf = (address << 88) | weight with injectivity range checks
    (census.py pack_census_leaf; reference imt.PackLeaf)."""
    a_bits = to_bits_canonical(cs, addr, 160)
    w_bits = to_bits_canonical(cs, weight, 88)
    del a_bits, w_bits  # canonical decomposition IS the range check
    return addr * (1 << 88) + weight


def leanimt_verify(cs, root, leaf, index_bits, siblings, actives, enabled):
    """Assert (when `enabled`) that `leaf` sits at index `index_bits`
    (little-endian booleans) under `root`.

    siblings/actives: fixed-length lists (max depth); inactive levels are
    promoted single-child levels (sibling ignored, index bit forced 0)."""
    h = leaf
    for sib, bit, act in zip(siblings, index_bits, actives):
        cs.assert_bool(act)
        # promoted levels are left children: inactive => bit == 0
        cs.assert_eq(cs.mul(cs.one - act, cs.coerce(bit)), cs.constant(0))
        left = cs.select(bit, sib, h)
        right = cs.select(bit, h, sib)
        nh = cs.poseidon([left, right])
        h = cs.select(act, nh, h)
    cs.assert_eq(cs.mul(enabled, h - root), cs.constant(0))


def _assert_on_curve_rte(cs, pt):
    """-x^2 + y^2 == 1 + d x^2 y^2 (RTE form)."""
    from davinci_tpu_torch.elgamal.bjj import D_RTE

    x, y = pt
    x2 = cs.mul(x, x)
    y2 = cs.mul(y, y)
    lhs = y2 - x2
    rhs = cs.one + cs.mul(x2, y2) * D_RTE
    cs.assert_eq(lhs, rhs)


def csp_eddsa_verify(
    cs, census_root, msg, pub_te, r8_te, s_val, enabled,
):
    """CSP certificate check (crypto/csp BabyJubJubEdDSA.verify_proof):
      * census_root == Poseidon(A.x, A.y)      (TE coordinates)
      * c = Poseidon(R8.x, R8.y, A.x, A.y, msg)
      * S*B8 == R8 + c*A                        (group equation, RTE)
    pub_te/r8_te: (x, y) LinComb pairs in TE coordinates; s_val: LinComb.
    Equalities are masked by `enabled`."""
    ax, ay = pub_te
    rx, ry = r8_te

    # root binding
    root_calc = cs.poseidon([ax, ay])
    cs.assert_eq(cs.mul(enabled, root_calc - census_root), cs.constant(0))

    # challenge (TE coordinates, matching the host signer)
    c = cs.poseidon([rx, ry, ax, ay, msg])

    # TE -> RTE is the linear scaling x' = f*x (bjj.py isomorphism)
    A = (ax * SCALING_F, ay)
    R8 = (rx * SCALING_F, ry)
    _assert_on_curve_rte(cs, A)
    _assert_on_curve_rte(cs, R8)

    s_bits = to_bits_canonical(cs, s_val, EDDSA_ORDER.bit_length())
    assert_bits_lt_const(cs, s_bits, EDDSA_ORDER)
    c_bits = to_bits_canonical(cs, c, cs.p.bit_length())

    B8 = (cs.constant(BASE8_RTE[0]), cs.constant(BASE8_RTE[1]))
    lhs = te_scalar_mul_bits(cs, B8, s_bits)
    cA = te_scalar_mul_bits(cs, A, c_bits)
    rhs = te_add(cs, R8, cA)
    cs.assert_eq(cs.mul(enabled, lhs[0] - rhs[0]), cs.constant(0))
    cs.assert_eq(cs.mul(enabled, lhs[1] - rhs[1]), cs.constant(0))
