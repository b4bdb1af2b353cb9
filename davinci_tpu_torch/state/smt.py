"""Sparse Merkle tree with circomlib/arbo semantics.

Semantics (reconstructed from the reference's in-circuit verifier,
circuits/merkleproof/merkleproof.go, and validated against the fixed
state-root construction in reference spec/hash/stateroot.go:28-84):
  * path = key bits, LSB first; max 64 levels (spec params)
  * leaf hash  = Poseidon(key, value, 1)
  * node hash  = Poseidon(left, right)
  * empty tree/subtree = 0
  * a leaf lives at the highest level where it is alone in its subtree
    (pushed down only to the first diverging bit on collision) — the tree
    is history-independent
  * multi-value leaves store Poseidon-multihash(values) as the value
    (reference merkleproof.go encodeLeafValue / arbo bigIntsToLeaf)

Transitions carry circomlib SMTProcessor conventions: fnc=(1,0) insert,
(0,1) update, (0,0) noop; siblings are the OLD tree's path siblings for the
affected key; non-membership is either an empty slot (is_old0=1) or a
colliding leaf (old_key/old_value).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from davinci_tpu_torch.hash import multi_poseidon, poseidon_hash

MAX_LEVELS = 64


def leaf_hash(key: int, value: int) -> int:
    return poseidon_hash([key, value, 1])


def node_hash(left: int, right: int) -> int:
    return poseidon_hash([left, right])


def encode_leaf_value(values: list[int]) -> int:
    """Single value -> itself; multiple -> Poseidon multihash."""
    if len(values) == 1:
        return values[0]
    return multi_poseidon(values)


def _bit(key: int, level: int) -> int:
    return (key >> level) & 1


@dataclass
class SMTProof:
    root: int
    key: int
    value: int          # value of the leaf if existence, else 0
    siblings: list      # top-down, variable length (<= MAX_LEVELS)
    existence: bool
    old_key: int = 0    # for exclusion: the colliding leaf (if any)
    old_value: int = 0
    is_old0: bool = True  # exclusion ended in an empty slot

    def padded_siblings(self, n: int = MAX_LEVELS) -> list:
        return list(self.siblings) + [0] * (n - len(self.siblings))


@dataclass
class SMTTransition:
    old_root: int
    new_root: int
    key: int          # new key
    value: int        # new value
    siblings: list    # old-tree path siblings (processor convention)
    fnc0: int         # (1,0) insert, (0,1) update, (0,0) noop
    fnc1: int
    is_old0: bool
    old_key: int
    old_value: int

    def padded_siblings(self, n: int = MAX_LEVELS) -> list:
        return list(self.siblings) + [0] * (n - len(self.siblings))


class SMT:
    """In-memory content-addressed SMT; snapshots are free (roots index an
    append-only node store), mirroring arbo's checkpoint-by-root model
    (reference state/state.go LoadSnapshotOnRoot)."""

    def __init__(self, max_levels: int = MAX_LEVELS):
        self.max_levels = max_levels
        self.root = 0
        # node store: hash -> ("node", l, r) | ("leaf", key, value)
        self.nodes: dict = {}

    # -- internals -----------------------------------------------------------

    def _put_leaf(self, key: int, value: int) -> int:
        h = leaf_hash(key, value)
        self.nodes[h] = ("leaf", key, value)
        return h

    def _put_node(self, l: int, r: int) -> int:
        h = node_hash(l, r)
        self.nodes[h] = ("node", l, r)
        return h

    def _kind(self, h: int):
        if h == 0:
            return ("empty",)
        return self.nodes[h]

    # -- queries -------------------------------------------------------------

    def get(self, key: int):
        h = self.root
        for lvl in range(self.max_levels):
            n = self._kind(h)
            if n[0] == "empty":
                return None
            if n[0] == "leaf":
                return n[2] if n[1] == key else None
            h = n[2] if _bit(key, lvl) else n[1]
        return None

    def prove(self, key: int) -> SMTProof:
        """Membership or non-membership proof for key."""
        siblings = []
        h = self.root
        for lvl in range(self.max_levels + 1):
            n = self._kind(h)
            if n[0] == "empty":
                return SMTProof(self.root, key, 0, siblings, False, 0, 0, True)
            if n[0] == "leaf":
                if n[1] == key:
                    return SMTProof(
                        self.root, key, n[2], siblings, True, n[1], n[2], False
                    )
                return SMTProof(
                    self.root, key, 0, siblings, False, n[1], n[2], False
                )
            if _bit(key, lvl):
                siblings.append(n[1])
                h = n[2]
            else:
                siblings.append(n[2])
                h = n[1]
        raise RuntimeError("max levels exceeded")

    # -- mutations -----------------------------------------------------------

    def insert(self, key: int, value: int) -> SMTTransition:
        pre = self.prove(key)
        assert not pre.existence, f"key {key} already in tree"
        old_root = self.root
        self.root = self._insert_at(self.root, key, value, 0)
        return SMTTransition(
            old_root=old_root,
            new_root=self.root,
            key=key,
            value=value,
            siblings=pre.siblings,
            fnc0=1,
            fnc1=0,
            is_old0=pre.is_old0,
            old_key=pre.old_key,
            old_value=pre.old_value,
        )

    def _insert_at(self, h: int, key: int, value: int, lvl: int) -> int:
        assert lvl < self.max_levels, "tree full along this path"
        n = self._kind(h)
        if n[0] == "empty":
            return self._put_leaf(key, value)
        if n[0] == "leaf":
            okey, oval = n[1], n[2]
            # push both leaves down to the first diverging bit
            return self._split(okey, oval, key, value, lvl)
        _, l, r = n
        if _bit(key, lvl):
            return self._put_node(l, self._insert_at(r, key, value, lvl + 1))
        return self._put_node(self._insert_at(l, key, value, lvl + 1), r)

    def _split(self, k1: int, v1: int, k2: int, v2: int, lvl: int) -> int:
        assert k1 != k2
        b1, b2 = _bit(k1, lvl), _bit(k2, lvl)
        if b1 != b2:
            h1 = self._put_leaf(k1, v1)
            h2 = self._put_leaf(k2, v2)
            return self._put_node(h2, h1) if b1 else self._put_node(h1, h2)
        child = self._split(k1, v1, k2, v2, lvl + 1)
        return self._put_node(0, child) if b1 else self._put_node(child, 0)

    def update(self, key: int, value: int) -> SMTTransition:
        pre = self.prove(key)
        assert pre.existence, f"key {key} not in tree"
        old_root = self.root
        self.root = self._update_at(self.root, key, value, 0)
        return SMTTransition(
            old_root=old_root,
            new_root=self.root,
            key=key,
            value=value,
            siblings=pre.siblings,
            fnc0=0,
            fnc1=1,
            is_old0=False,
            old_key=key,
            old_value=pre.value,
        )

    def _update_at(self, h: int, key: int, value: int, lvl: int) -> int:
        n = self._kind(h)
        if n[0] == "leaf":
            assert n[1] == key
            return self._put_leaf(key, value)
        _, l, r = n
        if _bit(key, lvl):
            return self._put_node(l, self._update_at(r, key, value, lvl + 1))
        return self._put_node(self._update_at(l, key, value, lvl + 1), r)

    def add_or_update(self, key: int, value: int) -> SMTTransition:
        if self.get(key) is None:
            return self.insert(key, value)
        return self.update(key, value)

    # -- verification (host oracle for the circuit gadget) -------------------

    @staticmethod
    def verify_proof(proof: SMTProof) -> bool:
        if proof.existence:
            h = leaf_hash(proof.key, proof.value)
        else:
            if proof.is_old0:
                h = 0
            else:
                if proof.old_key == proof.key:
                    return False
                h = leaf_hash(proof.old_key, proof.old_value)
        for lvl in reversed(range(len(proof.siblings))):
            sib = proof.siblings[lvl]
            if _bit(proof.key, lvl):
                h = node_hash(sib, h)
            else:
                h = node_hash(h, sib)
        return h == proof.root
