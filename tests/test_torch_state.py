"""The sequencer's state layer in davinci_tpu_torch (`state/smt.py`,
`state/state.py`, `census.py`: verbatim copies) held against the JAX
package's on the CPU.

The same seeded inserts and updates give the same SMT roots, proofs and
transitions in both packages; the same seeded votes give the same
`prepare_votes_batch` (roots, process proofs, transitions, results);
`CensusDB` gives the same roots, proofs and `prove_circuit` siblings.
"""

import dataclasses
import random

import pytest
import torch
from torch_c4_cases import election

from davinci_tpu import census as ref_census
from davinci_tpu.state import smt as ref_smt
from davinci_tpu_torch import census
from davinci_tpu_torch.state import smt

torch.set_num_threads(1)


def _ops(seed, n=24):
    """Seeded (op, key, value) triples: inserts of fresh keys, then
    updates and add-or-updates of keys already in the tree."""
    rng = random.Random(seed)
    keys = [rng.randrange(1 << 64) for _ in range(n)]
    ops = [("insert", k, rng.randrange(1 << 250)) for k in keys]
    ops += [("update", rng.choice(keys), rng.randrange(1 << 250))
            for _ in range(n // 2)]
    ops += [("add_or_update", k, rng.randrange(1 << 250))
            for k in (rng.choice(keys), rng.randrange(1 << 64))]
    return keys, ops


def _as_dict(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("seed", [1, 2])
def test_smt_roots_proofs_and_transitions_equal_the_reference(seed):
    keys, ops = _ops(seed)
    ref_tree, tree = ref_smt.SMT(), smt.SMT()
    for op, key, value in ops:
        want = getattr(ref_tree, op)(key, value)
        got = getattr(tree, op)(key, value)
        assert _as_dict(got) == _as_dict(want)
        assert tree.root == ref_tree.root
    absent = random.Random(seed + 100).randrange(1 << 64)
    for key in keys[:6] + [absent]:
        got, want = tree.prove(key), ref_tree.prove(key)
        assert _as_dict(got) == _as_dict(want)
        assert smt.SMT.verify_proof(got)
        assert got.padded_siblings(64) == want.padded_siblings(64)
        assert tree.get(key) == ref_tree.get(key)


def test_prepare_votes_batch_equals_the_reference():
    ref, port = election("davinci_tpu"), election("davinci_tpu_torch")
    want, got = ref["batch"], port["batch"]
    assert (got.root_before, got.root_after) == (want.root_before,
                                                 want.root_after)
    assert got.root_after == port["state"].root
    assert {k: _as_dict(p) for k, p in got.process_proofs.items()} == {
        k: _as_dict(p) for k, p in want.process_proofs.items()}
    for name in ("ballot_transitions", "voteid_transitions"):
        assert [_as_dict(t) for t in getattr(got, name)] == [
            _as_dict(t) for t in getattr(want, name)]
    assert _as_dict(got.results_transition) == _as_dict(
        want.results_transition)
    assert got.old_results.coords() == want.old_results.coords()
    assert got.new_results.coords() == want.new_results.coords()
    assert (got.voters_count, got.overwritten_count) == (
        want.voters_count, want.overwritten_count)
    assert [v.overwritten_ballot.coords() for v in got.votes] == [
        v.overwritten_ballot.coords() for v in want.votes]


def test_census_roots_and_proofs_equal_the_reference():
    rng = random.Random(0xCE)
    voters = [(rng.randrange(2**160), rng.randrange(1, 2**32))
              for _ in range(11)]
    dbs = []
    for mod in (ref_census, census):
        db = mod.CensusDB()
        db.new("c")
        for address, weight in voters:
            db.insert("c", address, weight)
        db.update_weight("c", voters[3][0], 7)
        dbs.append((db, db.publish("c")))
    (ref_db, ref_root), (db, root) = dbs
    assert root == ref_root
    for address, _ in voters:
        got = db.proof_by_root(root, address)
        assert got == ref_db.proof_by_root(ref_root, address)
        assert census.CensusDB.verify_proof(got)
    tree, ref_tree = db.by_id["c"].tree, ref_db.by_id["c"].tree
    for index in (0, 3, 10):
        for levels in (4, 20):
            assert tree.prove_circuit(index, levels) == ref_tree.prove_circuit(
                index, levels)
