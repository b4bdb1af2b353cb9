"""In-circuit SMT transition verification (insert/update/noop processor).

Role parity: the reference's MerkleTransition gadget
(circuits/merkleproof/merkleproof.go:133-229, circomlib SMTProcessor
semantics) — the core of the state-transition circuit: each of the batch's
ballot/voteID/results writes proves old_root -> new_root consistency.

Semantics mirror state/smt.py exactly (the host oracle):
  * leaf = Poseidon(key, value, 1), node = Poseidon(l, r), empty = 0;
  * the OLD tree's path siblings are the witness; depth is DERIVED from
    the last nonzero sibling (collision resistance pins it);
  * insert with collision pushes the old leaf down to the first diverging
    key bit; insert into an empty slot replaces a zero child; update
    rewrites the leaf in place; noop forces old_root == new_root.

Everything is unrolled over a fixed n_levels (64 in production,
parameterizable for CI), with boolean selects — no data-dependent control
flow, mirroring how the whole framework keeps XLA-friendly static shapes.
"""

from __future__ import annotations

from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb


def _leaf_hash_gadget(cs, key, value):
    return cs.poseidon([key, value, cs.one])


def _node_select(cs, bit, down, sib):
    """Combine child hash `down` with sibling by path bit: bit ? H(sib,
    down) : H(down, sib)."""
    l = cs.select(bit, sib, down)
    r = cs.select(bit, down, sib)
    return cs.poseidon([l, r])


def smt_transition_gadget(
    cs: ConstraintSystem,
    n_levels: int,
    old_root,
    new_root,
    key_bits: list,
    value,
    old_key_bits: list,
    old_value,
    is_old0,
    fnc0,
    fnc1,
    siblings: list,
):
    """Constrain (old_root -> new_root) to be the unique result of applying
    the (fnc0, fnc1) operation for (key, value).

    key_bits/old_key_bits: boolean LinCombs (LSB first, len n_levels);
    siblings: n_levels LinCombs (old-tree path siblings, zero-padded);
    fnc: (1,0) insert, (0,1) update, (0,0) noop.  All of value/old_value/
    is_old0/fnc/old roots may be variables."""
    assert len(key_bits) == len(old_key_bits) == n_levels
    assert len(siblings) == n_levels
    one, zero = cs.one, cs.constant(0)
    fnc0, fnc1 = cs.coerce(fnc0), cs.coerce(fnc1)
    is_old0 = cs.coerce(is_old0)
    cs.assert_bool(fnc0)
    cs.assert_bool(fnc1)
    cs.assert_bool(is_old0)
    cs.assert_eq(cs.mul(fnc0, fnc1), zero)  # mutually exclusive
    enabled = fnc0 + fnc1

    # -- depth derivation from siblings ------------------------------------
    sz = [cs.is_zero(s) for s in siblings]
    # azb[i] = all siblings at levels >= i are zero
    azb = [None] * (n_levels + 1)
    azb[n_levels] = one
    for i in reversed(range(n_levels)):
        azb[i] = cs.mul(azb[i + 1], sz[i])
    active = [one - azb[i] for i in range(n_levels)]  # [i <= last nonzero]

    # path consistency: keys must agree with old path up to the depth —
    # implied by hashing (the walk uses key bits), no separate constraint.

    # -- old-side value ------------------------------------------------------
    key = cs.from_bits(key_bits)
    old_key = cs.from_bits(old_key_bits)
    old_leaf_key_leaf = _leaf_hash_gadget(cs, key, old_value)      # update
    old_leaf_coll = _leaf_hash_gadget(cs, old_key, old_value)      # collision
    init_old = cs.select(
        fnc1,
        old_leaf_key_leaf,
        cs.select(is_old0, zero, old_leaf_coll),
    )

    # old walk (bottom-up, unrolled)
    c = init_old
    for i in reversed(range(n_levels)):
        comb = _node_select(cs, key_bits[i], c, siblings[i])
        c = cs.select(active[i], comb, c)
    # enabled ops must match old_root; noop checks nothing here
    cs.assert_eq(cs.mul(enabled, c - old_root), zero)

    # -- new-side ------------------------------------------------------------
    # divergence of key vs old_key (for collision inserts)
    dvg = [
        key_bits[i] + old_key_bits[i] - cs.mul(key_bits[i], old_key_bits[i]) * 2
        for i in range(n_levels)
    ]
    pre = [None] * (n_levels + 1)  # pre[i] = no divergence below level i
    pre[0] = one
    for i in range(n_levels):
        pre[i + 1] = cs.mul(pre[i], one - dvg[i])
    fd = [cs.mul(pre[i], dvg[i]) for i in range(n_levels)]  # first diverge

    is_coll = cs.mul(fnc0, one - is_old0)
    # a collision insert must actually diverge somewhere
    total_fd = zero
    for f in fd:
        total_fd = total_fd + f
    cs.assert_eq(cs.mul(is_coll, one - total_fd), zero)
    # an update must target the existing leaf (old_key == key, not old0)
    cs.assert_eq(cs.mul(fnc1, is_old0), zero)
    cs.assert_eq(cs.mul(fnc1, key - old_key), zero)

    newact = [
        cs.select(is_coll, pre[i + 1] + fd[i], active[i])
        for i in range(n_levels)
    ]
    # collision sibling schedule: old siblings below depth, zeros through
    # the pushdown chain, the old leaf at the diverging level
    sib_new = [
        cs.select(
            is_coll,
            cs.select(
                fd[i],
                old_leaf_coll,
                cs.select(active[i], siblings[i], zero),
            ),
            siblings[i],
        )
        for i in range(n_levels)
    ]

    init_new = _leaf_hash_gadget(cs, key, value)
    c2 = init_new
    for i in reversed(range(n_levels)):
        comb = _node_select(cs, key_bits[i], c2, sib_new[i])
        c2 = cs.select(newact[i], comb, c2)
    cs.assert_eq(cs.mul(enabled, c2 - new_root), zero)
    # noop: roots unchanged
    cs.assert_eq(cs.mul(one - enabled, old_root - new_root), zero)


def alloc_key_bits(cs: ConstraintSystem, key: int, n_levels: int) -> list:
    bits = []
    for i in range(n_levels):
        b = cs.priv_input((key >> i) & 1)
        cs.assert_bool(b)
        bits.append(b)
    return bits


def transition_to_gadget_inputs(cs: ConstraintSystem, t, n_levels: int):
    """Host SMTTransition (state/smt.py) -> allocated gadget inputs dict."""
    return dict(
        key_bits=alloc_key_bits(cs, t.key, n_levels),
        value=cs.priv_input(t.value),
        old_key_bits=alloc_key_bits(cs, t.old_key, n_levels),
        old_value=cs.priv_input(t.old_value),
        is_old0=cs.priv_input(int(t.is_old0)),
        fnc0=cs.priv_input(t.fnc0),
        fnc1=cs.priv_input(t.fnc1),
        siblings=[cs.priv_input(s) for s in t.padded_siblings(n_levels)],
    )
