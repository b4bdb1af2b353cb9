"""State sync: rebuild election state from on-chain EIP-4844 blobs.

Role parity: reference service/state_sync.go:96-240 (fetchBlobAndApply) +
state/blobs.go ParseBlobData — non-producing sequencers replay the chain's
blob stream into their local tree; the chain is the durable checkpoint
stream (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

from davinci_tpu_torch import spec
from davinci_tpu_torch.elgamal import Ballot
from davinci_tpu_torch.elgamal.bjj import BJJ
from davinci_tpu_torch.state import State
from davinci_tpu_torch.state.blobcodec import parse_blob_data


def apply_blob(state: State, blob_bytes: bytes) -> int:
    """Replay one transition blob into the local state; returns the new
    root.  Mirrors the producing sequencer's batch mutations exactly:
    per-vote ballot leaf + voteID leaf, then the results leaf."""
    data = parse_blob_data(blob_bytes)
    for v in data["votes"]:
        leaf_values = list(v["ballot_coords"]) + [v["address"], v["weight"]]
        state._add_or_update(v["ballot_index"], leaf_values)
        state._add_or_update(v["vote_id"], [spec.VOTE_ID_LEAF_VALUE])
    state._add_or_update(spec.STATE_KEY_RESULTS, list(data["results_coords"]))
    return state.root


class StateSync:
    """Follows a chain's blob stream for processes this node did not
    produce, replaying transitions until local and chain roots agree."""

    def __init__(self, chain, states: dict):
        self.chain = chain
        self.states = states
        self.applied: dict[int, int] = {}  # pid -> blob index consumed

    def tick(self):
        # in-order replay per process of any blobs not yet applied
        per_pid: dict[int, list] = {}
        for pid, blob_hex, *_ in self.chain.blobs:
            per_pid.setdefault(pid, []).append(blob_hex)
        for pid, blobs in per_pid.items():
            st = self.states.get(pid)
            info = self.chain.processes.get(pid)
            if st is None or info is None:
                continue
            start = self.applied.get(pid, 0)
            for blob_hex in blobs[start:]:
                if st.root == info.state_root:
                    break
                apply_blob(st, bytes.fromhex(blob_hex))
                self.applied[pid] = self.applied.get(pid, 0) + 1
