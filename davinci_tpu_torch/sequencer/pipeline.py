"""Sequencer pipeline: ballot -> aggregate -> state-transition -> on-chain ->
finalize, as explicit tick-driven processors over persistent queues.

Role parity: reference sequencer/ (sequencer.go Start/Stop + the five
processor loops: ballot.go, aggregate.go:364-446 batch-window trigger,
statetransition.go, onchain.go callback-driven settle/rollback,
finalizer.go) with service/mock_web3.go's chain-fake pattern for tests.

Ticks are explicit methods (deterministic tests, no goroutine translation);
a thread wrapper can drive them on intervals like the reference's tickers.
Circuits 2-4 (voteverifier / aggregator / statetransition) plug in through
the ProverSet interface; `DevStubProvers` marks its outputs as unproven —
the results path can run the real Groth16 results-verifier prover.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from dataclasses import dataclass, field

from davinci_tpu_torch import log

from davinci_tpu_torch import spec
from davinci_tpu_torch.elgamal import Ballot
from davinci_tpu_torch.elgamal.bjj import BJJ
from davinci_tpu_torch.state import State, Vote, ballot_index_key
from davinci_tpu_torch.storage import Storage, VoteIDStatus

VOTES_PER_BATCH = spec.VOTES_PER_BATCH


def _locked(fn):
    """Serialize pipeline mutation per sequencer — the reference's
    workInProgressLock (sequencer/sequencer.go:44): API threads and tick
    processors share Storage/State, so ticks are mutually exclusive."""

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self.work_lock:
            return fn(self, *a, **k)

    return wrapper


# ---------------------------------------------------------------------------
# Chain backend (fake) — reference service/mock_web3.go role
# ---------------------------------------------------------------------------


@dataclass
class ProcessInfo:
    process_id: int
    census_origin: int
    ballot_mode: int
    encryption_key: tuple
    state_root: int
    census_root: int = 0
    ended: bool = False
    results: list | None = None


class InMemoryChain:
    """In-memory stand-in for the Ethereum contracts + blob submission."""

    def __init__(self):
        self.processes: dict[int, ProcessInfo] = {}
        self.transitions: list = []
        self.blobs: list = []
        self.fail_next = False  # fault injection for rollback paths

    def create_process(self, info: ProcessInfo):
        self.processes[info.process_id] = info

    def process(self, pid: int) -> ProcessInfo:
        return self.processes[pid]

    def submit_transition(
        self, pid: int, root_before, root_after, proof, blob, sidecar=None
    ):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("chain: simulated submission failure")
        p = self.processes[pid]
        if p.state_root != root_before:
            raise RuntimeError("chain: root mismatch")
        if sidecar is not None:
            # version + proof-count guard, like the reference submission
            # path (sequencer/onchain.go:162-173)
            from davinci_tpu_torch.web3.blobtx import CELL_PROOFS_PER_BLOB

            if sidecar.get("version") != 1:
                raise RuntimeError(
                    f"chain: unexpected sidecar version {sidecar.get('version')}"
                )
            if len(sidecar["cell_proofs"]) != CELL_PROOFS_PER_BLOB:
                raise RuntimeError("chain: wrong cell-proof count")
        p.state_root = root_after
        self.transitions.append((pid, root_before, root_after, proof))
        self.blobs.append((pid, blob, sidecar))

    def end_process(self, pid: int):
        self.processes[pid].ended = True

    def submit_results(self, pid: int, results, proof):
        p = self.processes[pid]
        assert p.ended, "process not ended"
        p.results = results


# ---------------------------------------------------------------------------
# Prover set
# ---------------------------------------------------------------------------


class DevStubProvers:
    """Development stand-in for circuits 2-4 (vote verifier on BLS12-377,
    aggregator on BW6-761, state transition on BN254).  Outputs are clearly
    marked unproven; the real provers replace this as those circuits land
    (SURVEY.md §7.6)."""

    def prove_vote(self, vote_payload: dict) -> dict:
        return {"kind": "vote", "proven": False}

    def prove_aggregate(self, ballots: list) -> dict:
        return {"kind": "aggregate", "count": len(ballots), "proven": False}

    def prove_state_transition(self, batch_summary: dict) -> dict:
        return {"kind": "state_transition", "proven": False}

    def prove_results(self, witness) -> dict:
        return {"kind": "results", "proven": False}


# ---------------------------------------------------------------------------
# Vote wire format helpers
# ---------------------------------------------------------------------------


def ballot_to_wire(b: Ballot) -> list[int]:
    return b.coords()


def ballot_from_wire(coords: list[int]) -> Ballot:
    cts = []
    for i in range(0, len(coords), 4):
        cts.append(
            (BJJ(coords[i], coords[i + 1]), BJJ(coords[i + 2], coords[i + 3]))
        )
    return Ballot(cts)


# ---------------------------------------------------------------------------
# Sequencer
# ---------------------------------------------------------------------------


class Sequencer:
    def __init__(
        self,
        storage: Storage,
        chain: InMemoryChain,
        provers=None,
        batch_time_window: float = 300.0,
        max_dl_bound: int = 10**12,
        votes_per_batch: int = VOTES_PER_BATCH,
        census_levels: int = 20,
    ):
        self.storage = storage
        self.chain = chain
        self.work_lock = threading.RLock()
        self.provers = provers or DevStubProvers()
        self.batch_time_window = batch_time_window
        self.max_dl_bound = max_dl_bound
        self.votes_per_batch = votes_per_batch
        self.census_levels = census_levels
        self.states: dict[int, State] = {}
        self.voter_indices: dict[tuple, int] = {}  # (pid, address) -> index
        self.first_ballot_time: dict[int, float] = {}
        self.private_keys: dict[int, int] = {}  # finalizer demo keys

    # -- process lifecycle ---------------------------------------------------

    @_locked
    def register_process(self, info: ProcessInfo, priv_key: int | None = None):
        st = State(info.process_id)
        st.initialize(info.census_origin, info.ballot_mode, info.encryption_key)
        assert st.root == info.state_root, "initial root mismatch with chain"
        self.states[info.process_id] = st
        if priv_key is not None:
            self.private_keys[info.process_id] = priv_key

    # -- intake (API role) ---------------------------------------------------

    @_locked
    def submit_ballot(
        self, pid: int, address: int, ballot: Ballot, vote_id: int,
        weight: int = 1, client: dict | None = None,
        census_proof: dict | None = None,
    ):
        """Queue a pending ballot (API newVote semantics minus census/
        signature, which the api layer handles).  `client` carries the
        client-side proving material for circuit 2 (ballot proof, inputs
        hash, signature, pubkey); `census_proof` the api-verified census
        membership proof — reference api/vote.go newVote body."""
        self.storage.pending_ballots.push(
            {
                "pid": pid,
                "address": address,
                "vote_id": vote_id,
                "weight": weight,
                "ballot": ballot_to_wire(ballot),
                "client": client or {},
                "census_proof": census_proof,
            }
        )
        self.storage.set_vote_status(pid, vote_id, VoteIDStatus.PENDING)
        self.first_ballot_time.setdefault(pid, time.time())

    # -- processors ----------------------------------------------------------

    @_locked
    def tick_ballot(self, max_items: int = 8):
        """Pending -> verified (vote-verifier proof per ballot)."""
        for seq, item in self.storage.pending_ballots.next(max_items):
            proof = self.provers.prove_vote(item)
            item["vote_proof"] = proof
            self.storage.verified_ballots.push(item)
            self.storage.set_vote_status(
                item["pid"], item["vote_id"], VoteIDStatus.VERIFIED
            )
            self.storage.bump_stat(item["pid"], "verified_votes")
            self.storage.pending_ballots.done(seq)

    @_locked
    def tick_aggregate(self):
        """>=60 verified ballots or expired batch window -> aggregator proof
        (reference sequencer/aggregate.go:386-421 trigger logic)."""
        pending = self.storage.verified_ballots.size()
        if pending == 0:
            return
        window_expired = any(
            time.time() - t0 >= self.batch_time_window
            for t0 in self.first_ballot_time.values()
        )
        if pending < self.votes_per_batch and not window_expired:
            return
        items = self.storage.verified_ballots.next(self.votes_per_batch)
        if not items:
            return
        # native re-verify before batching (reference aggregate.go:37):
        # a bad stored proof fails HERE, not via the whole batch proof
        verify = getattr(self.provers, "verify_vote", None)
        if verify is not None:
            ok_items = []
            for seq, it in items:
                if verify(it):
                    ok_items.append((seq, it))
                else:
                    log.warnw(
                        "aggregate.invalid_vote_proof",
                        pid=it["pid"], vote_id=it["vote_id"],
                    )
                    self.storage.set_vote_status(
                        it["pid"], it["vote_id"], VoteIDStatus.ERROR
                    )
                    self.storage.verified_ballots.done(seq)
            items = ok_items
            if not items:
                return
        ballots = [it for _, it in items]
        agg_proof = self.provers.prove_aggregate(ballots)
        self.storage.agg_batches.push(
            {"pid": ballots[0]["pid"], "ballots": ballots, "proof": agg_proof}
        )
        for seq, it in items:
            self.storage.set_vote_status(
                it["pid"], it["vote_id"], VoteIDStatus.AGGREGATED
            )
            self.storage.bump_stat(it["pid"], "aggregated_votes")
            self.storage.verified_ballots.done(seq)
        for pid in {b["pid"] for b in ballots}:
            self.first_ballot_time.pop(pid, None)

    @_locked
    def tick_transition(self, rng=None):
        """Aggregated batch -> re-encrypt, state batch, blob, transition
        proof (reference sequencer/statetransition.go:48-205)."""
        import random as _random

        rng = rng or _random
        got = self.storage.agg_batches.next(1)
        if not got:
            return
        seq, batch = got[0]
        pid = batch["pid"]
        st = self.states[pid]
        pub = BJJ(*st.encryption_key())

        votes = []
        reenc_ks = []
        inputs_hashes = []
        census_proofs = []
        for it in batch["ballots"]:
            b = ballot_from_wire(it["ballot"])
            k_master = rng.randrange(1, 2**250)
            reenc, _ = b.reencrypt(pub, k_master)
            reenc_ks.append(k_master)
            inputs_hashes.append(
                int(it.get("client", {}).get("inputs_hash", "0x0"), 16)
            )
            # voter index: from the census proof when carried (its leaf /
            # signature position is what circuit 4 binds the ballot key
            # to), else arrival order (census-less dev flows)
            cproof = it.get("census_proof")
            key = (pid, it["address"])
            if cproof is not None:
                self.voter_indices[key] = (
                    cproof["index"]
                    if cproof.get("kind") == "merkle"
                    else cproof["voter_index"]
                )
                if cproof.get("kind") == "merkle":
                    from davinci_tpu_torch.census import (
                        circuit_proof_from_compressed,
                    )

                    census_proofs.append(
                        circuit_proof_from_compressed(
                            cproof, self.census_levels
                        )
                    )
                else:
                    from davinci_tpu_torch.csp import csp_circuit_proof

                    census_proofs.append(csp_circuit_proof(cproof))
            elif key not in self.voter_indices:
                self.voter_indices[key] = len(
                    [k for k in self.voter_indices if k[0] == pid]
                )
            if cproof is None:
                census_proofs.append(None)
            votes.append(
                Vote(
                    address=it["address"],
                    ballot_index=ballot_index_key(self.voter_indices[key]),
                    vote_id=it["vote_id"],
                    ballot=b,
                    reencrypted_ballot=reenc,
                    weight=it["weight"],
                )
            )
        result = st.prepare_votes_batch(votes)

        # blob packing + KZG eval data (reference state/blobs.go); the
        # eval point/value feed circuit 4's blob binding when enabled
        from davinci_tpu_torch.state.blobcodec import pack_batch_blob

        wants_kzg = bool(
            getattr(self.provers, "c4_overrides", {}).get("include_blob")
        )
        blob_info = pack_batch_blob(pid, result, with_kzg=wants_kzg)

        # EIP-7594 sidecar (version 1: 128 cell proofs) — opt-in, heavy
        # (reference sequencer/onchain.go:168-173, types/blobs.go:90-162)
        import os as _os

        sidecar = None
        if _os.environ.get("DAVINCI_CELL_PROOFS"):
            from davinci_tpu_torch.blobs.cells import compute_cell_proofs_device
            from davinci_tpu_torch.blobs.kzg import Blob, blob_to_commitment

            blob_obj = Blob.from_bytes(bytes.fromhex(blob_info["blob_hex"]))
            with log.info_time("blob.cell_proofs", pid=pid):
                commitment = blob_to_commitment(blob_obj)
                cell_proofs = compute_cell_proofs_device(blob_obj)
            sidecar = {
                "version": 1,
                "commitment": commitment.hex(),
                "cell_proofs": [p.hex() for p in cell_proofs],
            }

        from davinci_tpu_torch.circuits.statetransition import StateTransitionWitness

        info = self.chain.processes.get(pid)
        st_witness = StateTransitionWitness(
            batch=result,
            process_id=pid,
            ballot_mode_packed=info.ballot_mode if info else 0,
            encryption_key=st.encryption_key(),
            census_origin=info.census_origin if info else 0,
            reenc_k=reenc_ks,
            inputs_hashes=inputs_hashes,
            agg_proof=batch["proof"],
            census_root=info.census_root if info else 0,
            census_proofs=(
                census_proofs if any(p is not None for p in census_proofs)
                else None
            ),
            blob_z=blob_info.get("z", 0),
            blob_y=blob_info.get("y", 0),
        )
        proof = self.provers.prove_state_transition(
            {
                "pid": pid,
                "root_before": result.root_before,
                "root_after": result.root_after,
                "agg_proof": batch["proof"],
                "witness": st_witness,
                "n_votes": self.votes_per_batch,
                "census_levels": self.census_levels,
            }
        )
        self.storage.transition_batches.push(
            {
                "pid": pid,
                "root_before": result.root_before,
                "root_after": result.root_after,
                "proof": proof,
                "blob": blob_info["blob_hex"],
                "sidecar": sidecar,
                "vote_ids": [v.vote_id for v in votes],
            }
        )
        for v in votes:
            self.storage.set_vote_status(pid, v.vote_id, VoteIDStatus.PROCESSED)
        self.storage.bump_stat(pid, "state_transitions")
        self.storage.agg_batches.done(seq)

    @_locked
    def tick_onchain(self):
        """Submit transitions; settle on success, roll back on failure
        (reference sequencer/onchain.go:135-279)."""
        got = self.storage.transition_batches.next(1)
        if not got:
            return
        seq, t = got[0]
        pid = t["pid"]
        try:
            self.chain.submit_transition(
                pid, t["root_before"], t["root_after"], t["proof"], t["blob"],
                sidecar=t.get("sidecar"),
            )
        except RuntimeError:
            # rollback: release the item for retry and restore state
            self.states[pid].rollback_last_batch()
            self.storage.transition_batches.release(seq)
            return
        for vid in t["vote_ids"]:
            self.storage.set_vote_status(pid, vid, VoteIDStatus.SETTLED)
        self.storage.bump_stat(pid, "settled_transitions")
        self.storage.transition_batches.done(seq)

    @_locked
    def tick_finalizer(self, rng=None, prove_real: bool = False):
        """Ended processes: decrypt results + decryption proofs + results
        proof (reference sequencer/finalizer.go:266-451)."""
        from davinci_tpu_torch.circuits.results import results_witness_from_state

        for pid, st in self.states.items():
            info = self.chain.processes.get(pid)
            if not info or not info.ended or info.results is not None:
                continue
            if info.state_root != st.root:
                continue  # not synced
            priv = self.private_keys.get(pid)
            if priv is None:
                continue
            w = results_witness_from_state(st, priv, self.max_dl_bound, rng)
            if prove_real:
                # real results-verifier prove through the artifact cache —
                # setup runs once per circuit structure, never per finalize
                # (reference circuits/artifacts.go LoadOrDownload semantics)
                from davinci_tpu_torch.circuits.artifacts import default_store
                from davinci_tpu_torch.circuits.results import build_results_circuit
                from davinci_tpu_torch.groth16.serialize import proof_to_dict

                cs = build_results_circuit(w)
                rt = default_store().load_or_setup("results-v1", "bn254", cs)
                proof = rt.prove_and_verify(cs)
                # the actual proof is kept and submitted (reference
                # sequencer/onchain.go:280 processResultsOnChain)
                proof_blob = {
                    "kind": "results",
                    "proven": True,
                    "proof": proof_to_dict(proof),
                    "public": [hex(x) for x in cs.public_values()],
                }
            else:
                proof_blob = self.provers.prove_results(w)
            log.infow(
                "finalizer.results", pid=pid, proven=proof_blob.get("proven"),
            )
            self.chain.submit_results(pid, w.results, proof_blob)
            self.storage.verified_results.push(
                {"pid": pid, "results": w.results, "proof": proof_blob}
            )
