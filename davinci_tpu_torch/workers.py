"""Distributed proving farm: master-side job/worker management + worker
client loop.

Role parity: reference workers/ (jobs_manager.go:39-227 pending jobs with
timeouts, worker_manager.go:98-287 failure accounting with time bans — 3
consecutive failures => 30 min ban, authtoken.go UUID-from-seed + token
auth) and sequencer/worker.go (fetchJobFromMaster/submitJobToMaster loop).

This HTTP rim exists for protocol interop; the TPU-native scale-out path is
pod-slice SPMD sharding (davinci_tpu_torch.msm.sharded_msm / parallel docs,
SURVEY.md §2.4) where votes shard across hosts via the device mesh.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import uuid as _uuid
from dataclasses import dataclass, field

BAN_AFTER_FAILURES = 3
BAN_SECONDS = 30 * 60
JOB_TIMEOUT = 60.0


def worker_uuid(seed: str, name: str) -> str:
    """Deterministic worker UUID from the master seed + worker name
    (reference workers/authtoken.go)."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return str(_uuid.UUID(bytes=digest[:16]))


def auth_token(seed: str, worker: str, expiry: float) -> str:
    mac = hmac.new(
        seed.encode(), f"{worker}:{int(expiry)}".encode(), hashlib.sha256
    ).hexdigest()
    return f"{int(expiry)}:{mac}"


def check_auth_token(seed: str, worker: str, token: str) -> bool:
    try:
        exp_s, mac = token.split(":", 1)
        expiry = int(exp_s)
    except ValueError:
        return False
    if expiry < time.time():
        return False
    want = hmac.new(
        seed.encode(), f"{worker}:{expiry}".encode(), hashlib.sha256
    ).hexdigest()
    return hmac.compare_digest(mac, want)


@dataclass
class WorkerStats:
    success: int = 0
    failures: int = 0
    consecutive_failures: int = 0
    banned_until: float = 0.0

    @property
    def banned(self) -> bool:
        return time.time() < self.banned_until


class WorkerManager:
    def __init__(
        self,
        seed: str,
        ban_after: int = BAN_AFTER_FAILURES,
        ban_seconds: float = BAN_SECONDS,
    ):
        self.seed = seed
        self.ban_after = ban_after
        self.ban_seconds = ban_seconds
        self.workers: dict[str, WorkerStats] = {}

    def stats_for(self, wid: str) -> WorkerStats:
        return self.workers.setdefault(wid, WorkerStats())

    def allowed(self, wid: str) -> bool:
        return not self.stats_for(wid).banned

    def record_success(self, wid: str):
        st = self.stats_for(wid)
        st.success += 1
        st.consecutive_failures = 0

    def record_failure(self, wid: str):
        st = self.stats_for(wid)
        st.failures += 1
        st.consecutive_failures += 1
        if st.consecutive_failures >= self.ban_after:
            st.banned_until = time.time() + self.ban_seconds
            st.consecutive_failures = 0

    def snapshot(self) -> dict:
        return {
            wid: {
                "success": s.success,
                "failures": s.failures,
                "banned": s.banned,
            }
            for wid, s in self.workers.items()
        }


class JobsManager:
    """Hands pending ballots to workers; timed-out jobs return to the queue
    (the reservation machinery in storage provides the timeout semantics)."""

    def __init__(self, storage, worker_manager: WorkerManager):
        self.storage = storage
        self.wm = worker_manager
        self.inflight: dict[str, tuple] = {}  # job_id -> (seq, worker, t0)

    def get_job(self, wid: str) -> dict | None:
        if not self.wm.allowed(wid):
            return None
        got = self.storage.pending_ballots.next(1)
        if not got:
            return None
        seq, item = got[0]
        job_id = f"{wid}:{seq}"
        self.inflight[job_id] = (seq, wid, time.time())
        return {"job_id": job_id, "ballot": item}

    def submit_job(self, wid: str, job_id: str, result: dict) -> bool:
        entry = self.inflight.pop(job_id, None)
        if entry is None:
            return False
        seq, owner, _ = entry
        if owner != wid:
            return False
        if not result.get("ok"):
            self.wm.record_failure(wid)
            self.storage.pending_ballots.release(seq)
            return False
        item = result["ballot"]
        item["vote_proof"] = result["proof"]
        self.storage.verified_ballots.push(item)
        from davinci_tpu_torch.storage import VoteIDStatus

        self.storage.set_vote_status(
            item["pid"], item["vote_id"], VoteIDStatus.VERIFIED
        )
        self.storage.bump_stat(item["pid"], "verified_votes")
        self.storage.pending_ballots.done(seq)
        self.wm.record_success(wid)
        return True


class WorkerClient:
    """Worker-mode loop: fetch -> prove -> submit (reference
    sequencer/worker.go:255-311), transport-injectable for tests."""

    def __init__(self, wid: str, transport, provers):
        self.wid = wid
        self.transport = transport  # (method, path, body) -> dict
        self.provers = provers

    def tick(self) -> bool:
        job = self.transport("GET", f"/workers/{self.wid}/job", None)
        if not job or "job_id" not in job:
            return False
        try:
            proof = self.provers.prove_vote(job["ballot"])
            result = {"ok": True, "ballot": job["ballot"], "proof": proof}
        except Exception as e:
            result = {"ok": False, "error": str(e)}
        self.transport(
            "POST", f"/workers/{self.wid}/job/{job['job_id']}", result
        )
        return True
