"""Per-process election state machine over the SMT.

Role parity: reference state/state.go (State over arbo), state/vote.go (vote
leaves), state/batch.go (staged Batch producing the 60-vote transition
witness: process proofs at root-before, per-vote ballot + voteID
transitions in circuit order, results transition, root-after).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from davinci_tpu_torch import spec
from davinci_tpu_torch.elgamal import Ballot
from davinci_tpu_torch.state.smt import SMT, SMTProof, SMTTransition, encode_leaf_value

VOTE_ID_LEAF_VALUE = spec.VOTE_ID_LEAF_VALUE
BALLOT_LEAF_COORDS = spec.FIELDS_PER_BALLOT * 4


def ballot_index_key(voter_index: int) -> int:
    """BallotIndex = BallotMin + voterIndex (reference types/state.go:46-48)."""
    assert 0 <= voter_index <= spec.VOTER_INDEX_MAX
    return spec.BALLOT_MIN + voter_index


@dataclass
class Vote:
    """A vote entering a state batch (reference state/vote.go Vote)."""

    address: int
    ballot_index: int       # full state key (BALLOT_MIN + voter index)
    vote_id: int            # full state key (top bit set)
    ballot: Ballot          # as submitted
    reencrypted_ballot: Ballot
    weight: int = 1
    overwritten_ballot: Ballot | None = None

    def tree_leaf_values(self) -> list[int]:
        """ballot coords (32), address, weight (reference vote.go:31-44)."""
        return self.reencrypted_ballot.coords() + [self.address, self.weight]


def noop_transition(root: int) -> SMTTransition:
    return SMTTransition(
        old_root=root,
        new_root=root,
        key=0,
        value=0,
        siblings=[],
        fnc0=0,
        fnc1=0,
        is_old0=True,
        old_key=0,
        old_value=0,
    )


@dataclass
class BatchResult:
    root_before: int
    root_after: int
    process_proofs: dict          # key name -> SMTProof
    ballot_transitions: list      # 60 SMTTransition
    voteid_transitions: list      # 60 SMTTransition
    results_transition: SMTTransition
    old_results: Ballot
    new_results: Ballot
    votes: list                   # the (unpadded) votes
    voters_count: int
    overwritten_count: int


class State:
    """Election state: SMT + raw leaf-value store (arbo keeps values too)."""

    def __init__(self, process_id: int):
        self.process_id = process_id
        self.tree = SMT()
        self.leaf_values: dict[int, list[int]] = {}

    # -- init ----------------------------------------------------------------

    def initialize(
        self,
        census_origin: int,
        ballot_mode_packed: int,
        enc_key: tuple,
    ):
        """Insert the 5 config leaves (reference state/state.go:260-280)."""
        zero_coords = Ballot.zero().coords()
        self._add(spec.STATE_KEY_PROCESS_ID, [self.process_id])
        self._add(spec.STATE_KEY_BALLOT_MODE, [ballot_mode_packed])
        self._add(spec.STATE_KEY_ENCRYPTION_KEY, [enc_key[0], enc_key[1]])
        self._add(spec.STATE_KEY_RESULTS, zero_coords)
        self._add(spec.STATE_KEY_CENSUS_ORIGIN, [census_origin])
        return self.tree.root

    def _add(self, key: int, values: list[int]) -> SMTTransition:
        tr = self.tree.insert(key, encode_leaf_value(values))
        self.leaf_values[key] = list(values)
        return tr

    def _update(self, key: int, values: list[int]) -> SMTTransition:
        tr = self.tree.update(key, encode_leaf_value(values))
        self.leaf_values[key] = list(values)
        return tr

    def _add_or_update(self, key: int, values: list[int]) -> SMTTransition:
        if self.tree.get(key) is None:
            return self._add(key, values)
        return self._update(key, values)

    # -- queries -------------------------------------------------------------

    @property
    def root(self) -> int:
        return self.tree.root

    def results(self) -> Ballot:
        vals = self.leaf_values[spec.STATE_KEY_RESULTS]
        return _ballot_from_coords(vals[:BALLOT_LEAF_COORDS])

    def encryption_key(self) -> tuple:
        v = self.leaf_values[spec.STATE_KEY_ENCRYPTION_KEY]
        return (v[0], v[1])

    def ballot_leaf(self, ballot_index: int):
        vals = self.leaf_values.get(ballot_index)
        if vals is None:
            return None
        return (
            _ballot_from_coords(vals[:BALLOT_LEAF_COORDS]),
            vals[BALLOT_LEAF_COORDS],
            vals[BALLOT_LEAF_COORDS + 1],
        )

    # -- batch ---------------------------------------------------------------

    def prepare_votes_batch(self, votes: list[Vote]) -> BatchResult:
        """Stage a <=60-vote batch, producing the full transition witness in
        circuit order (reference state/batch.go:234-303).  The tree is
        mutated; roll back with `rollback(root_before)` if needed."""
        assert len(votes) <= spec.VOTES_PER_BATCH, "too many votes"
        root_before = self.tree.root
        snapshot_values = dict(self.leaf_values)
        self._last_snapshot = (root_before, snapshot_values)

        process_proofs = {
            "id": self.tree.prove(spec.STATE_KEY_PROCESS_ID),
            "census_origin": self.tree.prove(spec.STATE_KEY_CENSUS_ORIGIN),
            "ballot_mode": self.tree.prove(spec.STATE_KEY_BALLOT_MODE),
            "encryption_key": self.tree.prove(spec.STATE_KEY_ENCRYPTION_KEY),
        }

        all_sum = Ballot.zero()
        overwritten_sum = Ballot.zero()
        overwritten_count = 0
        voters_count = 0
        for v in votes:
            old_leaf = self.ballot_leaf(v.ballot_index)
            if old_leaf is not None:
                old_ballot, old_addr, old_weight = old_leaf
                assert old_addr == v.address and old_weight == v.weight, (
                    "stored ballot leaf metadata mismatch"
                )
                overwritten_sum = overwritten_sum.add(old_ballot)
                overwritten_count += 1
                v.overwritten_ballot = old_ballot
            else:
                v.overwritten_ballot = Ballot.zero()
            all_sum = all_sum.add(v.reencrypted_ballot)
            voters_count += 1

        ballot_trs = []
        voteid_trs = []
        for i in range(spec.VOTES_PER_BATCH):
            if i < len(votes):
                v = votes[i]
                ballot_trs.append(
                    self._add_or_update(v.ballot_index, v.tree_leaf_values())
                )
                voteid_trs.append(
                    self._add_or_update(v.vote_id, [VOTE_ID_LEAF_VALUE])
                )
            else:
                ballot_trs.append(noop_transition(self.tree.root))
                voteid_trs.append(noop_transition(self.tree.root))

        old_results = _ballot_from_coords(
            snapshot_values[spec.STATE_KEY_RESULTS][:BALLOT_LEAF_COORDS]
        )
        new_results = old_results.add(all_sum).add(_neg_ballot(overwritten_sum))
        results_tr = self._add_or_update(
            spec.STATE_KEY_RESULTS, new_results.coords()
        )

        return BatchResult(
            root_before=root_before,
            root_after=self.tree.root,
            process_proofs=process_proofs,
            ballot_transitions=ballot_trs,
            voteid_transitions=voteid_trs,
            results_transition=results_tr,
            old_results=old_results,
            new_results=new_results,
            votes=list(votes),
            voters_count=voters_count,
            overwritten_count=overwritten_count,
        )

    def rollback(self, root: int, leaf_values: dict | None = None):
        """Discard staged mutations: SMT nodes are content-addressed, so
        restoring a root is O(1) (reference Batch.Discard)."""
        self.tree.root = root
        if leaf_values is not None:
            self.leaf_values = leaf_values

    def rollback_last_batch(self):
        root, values = self._last_snapshot
        self.rollback(root, values)


def _ballot_from_coords(coords: list[int]) -> Ballot:
    from davinci_tpu_torch.elgamal.bjj import BJJ

    cts = []
    for i in range(0, BALLOT_LEAF_COORDS, 4):
        cts.append(
            (BJJ(coords[i], coords[i + 1]), BJJ(coords[i + 2], coords[i + 3]))
        )
    return Ballot(cts)


def _neg_ballot(b: Ballot) -> Ballot:
    return Ballot([(c1.neg(), c2.neg()) for c1, c2 in b.ciphertexts])
