"""Census: LeanIMT (zk-kit style incremental Merkle tree) with Poseidon
hashing + census database with working -> published lifecycle.

Role parity: reference census/ (censusdb over vocdoni/lean-imt-go,
censusdb.go:87+; leaf packing (address << 88) | weight, validated against
the Solidity-compatibility vectors embedded in the reference tests
census/censusdb/solidity_compatibility_test.go:28-58).

LeanIMT semantics: leaves are appended; a node with no right child *is* its
left child (no padding); depth = ceil(log2(n)); proofs carry the leaf index
(path bits) and the non-degenerate siblings only.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass

from davinci_tpu_torch.hash import poseidon_hash

WEIGHT_BITS = 88


def pack_census_leaf(address: int, weight: int) -> int:
    """leaf = (address << 88) | weight."""
    assert 0 <= address < (1 << 160)
    assert 0 <= weight < (1 << WEIGHT_BITS)
    return (address << WEIGHT_BITS) | weight


def unpack_census_leaf(leaf: int) -> tuple:
    return leaf >> WEIGHT_BITS, leaf & ((1 << WEIGHT_BITS) - 1)


class LeanIMT:
    def __init__(self):
        # levels[0] = leaves; levels[k] = nodes at height k
        self.levels: list[list[int]] = [[]]

    @property
    def size(self) -> int:
        return len(self.levels[0])

    @property
    def depth(self) -> int:
        n = self.size
        return 0 if n <= 1 else (n - 1).bit_length()

    @property
    def root(self) -> int:
        if self.size == 0:
            return 0
        return self.levels[-1][0]

    def _rebuild_path(self, index: int):
        """Recompute ancestors of leaf `index` (append/update share this)."""
        # grow level list if depth increased
        want_levels = self.depth + 1
        while len(self.levels) < want_levels:
            self.levels.append([])
        while len(self.levels) > want_levels:
            self.levels.pop()
        i = index
        for lvl in range(self.depth):
            cur = self.levels[lvl]
            parent_i = i // 2
            l = cur[2 * parent_i]
            if 2 * parent_i + 1 < len(cur):
                node = poseidon_hash([l, cur[2 * parent_i + 1]])
            else:
                node = l  # single child propagates
            nxt = self.levels[lvl + 1]
            if parent_i < len(nxt):
                nxt[parent_i] = node
            else:
                assert parent_i == len(nxt)
                nxt.append(node)
            i = parent_i

    def insert(self, leaf: int):
        self.levels[0].append(leaf)
        # depth growth can require recomputing the whole right spine; easiest
        # correct approach: rebuild affected path after adjusting levels
        if len(self.levels) != self.depth + 1:
            self._full_rebuild()
        else:
            self._rebuild_path(self.size - 1)

    def update(self, index: int, leaf: int):
        assert 0 <= index < self.size
        self.levels[0][index] = leaf
        self._rebuild_path(index)

    def _full_rebuild(self):
        leaves = self.levels[0]
        self.levels = [list(leaves)]
        for _ in range(self.depth):
            cur = self.levels[-1]
            nxt = []
            for i in range(0, len(cur), 2):
                if i + 1 < len(cur):
                    nxt.append(poseidon_hash([cur[i], cur[i + 1]]))
                else:
                    nxt.append(cur[i])
            self.levels.append(nxt)

    def prove(self, index: int):
        """Returns (leaf, index, siblings): siblings bottom-up, skipping
        single-child levels (LeanIMT proof format)."""
        assert 0 <= index < self.size
        siblings = []
        path_bits = []
        i = index
        for lvl in range(self.depth):
            cur = self.levels[lvl]
            sib_i = i ^ 1
            if sib_i < len(cur):
                siblings.append(cur[sib_i])
                path_bits.append(i & 1)
            i //= 2
        return self.levels[0][index], index, siblings, path_bits

    def prove_circuit(self, index: int, max_depth: int):
        """Circuit-witness proof: per TREE level (not compressed), returns
        (leaf, siblings, actives, index_bits) each padded to `max_depth`.

        The compressed `prove()` format is ambiguous in-circuit (two leaves
        at different depths can share the same active-bit string), so the
        gadget consumes per-level alignment: `actives[l]` says whether level
        l consumed a sibling, and promoted (single-child) levels carry a
        forced-0 index bit — making `index = sum bits[l] 2^l` exact."""
        assert 0 <= index < self.size
        assert self.depth <= max_depth
        siblings, actives, bits = [], [], []
        i = index
        for lvl in range(self.depth):
            cur = self.levels[lvl]
            sib_i = i ^ 1
            if sib_i < len(cur):
                siblings.append(cur[sib_i])
                actives.append(1)
            else:
                siblings.append(0)
                actives.append(0)
            bits.append(i & 1)
            i //= 2
        pad = max_depth - len(bits)
        return (
            self.levels[0][index],
            siblings + [0] * pad,
            actives + [0] * pad,
            bits + [0] * pad,
        )

    @staticmethod
    def verify(root: int, leaf: int, siblings: list, path_bits: list) -> bool:
        h = leaf
        for sib, bit in zip(siblings, path_bits):
            h = poseidon_hash([sib, h] if bit else [h, sib])
        return h == root


@dataclass
class CensusRef:
    census_id: str
    tree: LeanIMT
    published: bool = False
    index_by_address: dict = None

    def __post_init__(self):
        if self.index_by_address is None:
            self.index_by_address = {}


class CensusDB:
    """uuid-keyed working censuses; publishing freezes them and indexes by
    root (reference censusdb working -> published lifecycle)."""

    def __init__(self):
        self.by_id: dict[str, CensusRef] = {}
        self.by_root: dict[int, CensusRef] = {}

    def new(self, census_id: str | None = None) -> CensusRef:
        cid = census_id or str(_uuid.uuid4())
        ref = CensusRef(cid, LeanIMT())
        self.by_id[cid] = ref
        return ref

    def insert(self, cid: str, address: int, weight: int):
        ref = self.by_id[cid]
        assert not ref.published, "census already published"
        if address in ref.index_by_address:
            raise ValueError("address already in census")
        ref.index_by_address[address] = ref.tree.size
        ref.tree.insert(pack_census_leaf(address, weight))

    def update_weight(self, cid: str, address: int, weight: int):
        ref = self.by_id[cid]
        idx = ref.index_by_address[address]
        ref.tree.update(idx, pack_census_leaf(address, weight))

    def publish(self, cid: str) -> int:
        ref = self.by_id[cid]
        ref.published = True
        self.by_root[ref.tree.root] = ref
        return ref.tree.root

    def proof_by_root(self, root: int, address: int):
        ref = self.by_root[root]
        idx = ref.index_by_address[address]
        leaf, index, siblings, bits = ref.tree.prove(idx)
        _, weight = unpack_census_leaf(leaf)
        return {
            "kind": "merkle",
            "root": root,
            "address": address,
            "weight": weight,
            "leaf": leaf,
            "index": index,
            "size": ref.tree.size,
            "siblings": siblings,
            "path_bits": bits,
        }

    @staticmethod
    def verify_proof(proof: dict) -> bool:
        if pack_census_leaf(proof["address"], proof["weight"]) != proof["leaf"]:
            return False
        return LeanIMT.verify(
            proof["root"], proof["leaf"], proof["siblings"], proof["path_bits"]
        )


def circuit_proof_from_compressed(proof: dict, max_depth: int) -> dict:
    """Spread a compressed LeanIMT proof (siblings at active levels only,
    from `prove`/`proof_by_root` + the tree `size`) onto per-tree-level
    (siblings, actives, index_bits) circuit-witness form — the shape
    `circuits/census_gadget.leanimt_verify` consumes.

    A wire proof can carry `size` because the active-level pattern for a
    given (index, size) is deterministic: level l consumes a sibling iff
    (index>>l)^1 < ceil(size / 2^l)."""
    index, size = proof["index"], proof["size"]
    depth = 0 if size <= 1 else (size - 1).bit_length()
    assert depth <= max_depth, (depth, max_depth)
    sibs, acts, bits = [], [], []
    comp = list(proof["siblings"])
    i, n = index, size
    for _ in range(depth):
        if (i ^ 1) < n:
            sibs.append(comp.pop(0))
            acts.append(1)
        else:
            sibs.append(0)
            acts.append(0)
        bits.append(i & 1)
        i //= 2
        n = (n + 1) // 2
    assert not comp, "sibling count mismatch vs (index, size)"
    pad = max_depth - depth
    return {
        "kind": "merkle",
        "siblings": sibs + [0] * pad,
        "actives": acts + [0] * pad,
        "index_bits": bits + [0] * pad,
        "index": index,
    }
