"""Pipeline storage: prefixed FIFO queues with timestamped reservations,
vote-ID status machine, per-process stats.

Role parity: reference storage/ (prefix map storage.go:6-57; queue
push/next/pull with reservations ballots.go; vote_id_status.go state
machine pending -> verified -> aggregated -> processed -> settled/error;
stale-reservation release + crash cleanup cleanup.go; process_stats.go).
"""

from __future__ import annotations

import json
import threading
import time
from enum import IntEnum


class VoteIDStatus(IntEnum):
    PENDING = 0
    VERIFIED = 1
    AGGREGATED = 2
    PROCESSED = 3
    SETTLED = 4
    ERROR = 5


# transition whitelist (reference storage/vote_id_status.go)
_VALID_NEXT = {
    VoteIDStatus.PENDING: {VoteIDStatus.VERIFIED, VoteIDStatus.ERROR},
    VoteIDStatus.VERIFIED: {VoteIDStatus.AGGREGATED, VoteIDStatus.ERROR},
    VoteIDStatus.AGGREGATED: {VoteIDStatus.PROCESSED, VoteIDStatus.ERROR},
    VoteIDStatus.PROCESSED: {VoteIDStatus.SETTLED, VoteIDStatus.ERROR},
    VoteIDStatus.SETTLED: set(),
    VoteIDStatus.ERROR: set(),
}

# key prefixes (role parity with reference storage/storage.go prefix map)
_P_QUEUE = b"q/"
_P_RESV = b"r/"
_P_STATUS = b"s/"
_P_STATS = b"t/"
_P_SEQ = b"n/"
_P_DATA = b"d/"


def _now() -> float:
    return time.time()


class Queue:
    """FIFO queue with reservations over a KV namespace."""

    def __init__(self, kv, name: str, reservation_timeout: float = 60.0, lock=None):
        self.kv = kv
        self.name = name.encode()
        self.timeout = reservation_timeout
        # shared with the owning Storage when present: the reference guards
        # all queue mutation behind a global lock (storage globalLock)
        self.lock = lock or threading.RLock()

    def _seq_next(self) -> int:
        key = _P_SEQ + self.name
        cur = int(self.kv.get(key) or b"0")
        self.kv.put(key, str(cur + 1).encode())
        return cur

    def _qkey(self, seq: int) -> bytes:
        return _P_QUEUE + self.name + b"/" + seq.to_bytes(8, "big")

    def push(self, item: dict) -> int:
        with self.lock:
            seq = self._seq_next()
            self.kv.put(self._qkey(seq), json.dumps(item).encode())
            return seq

    def next(self, max_items: int = 1) -> list[tuple[int, dict]]:
        """Reserve and return up to max_items unreserved items (FIFO)."""
        now = _now()
        with self.lock:
            return self._next_locked(max_items, now)

    def _next_locked(self, max_items, now):
        out = []
        for k, v in self.kv.iter_prefix(_P_QUEUE + self.name + b"/"):
            seq = int.from_bytes(k[-8:], "big")
            rkey = _P_RESV + self.name + b"/" + k[-8:]
            resv = self.kv.get(rkey)
            if resv is not None and now - float(resv) < self.timeout:
                continue
            self.kv.put(rkey, str(now).encode())
            out.append((seq, json.loads(v)))
            if len(out) >= max_items:
                break
        return out

    def done(self, seq: int):
        """Remove a completed item and its reservation."""
        self.kv.delete(self._qkey(seq))
        self.kv.delete(_P_RESV + self.name + b"/" + seq.to_bytes(8, "big"))

    def release(self, seq: int):
        """Return a reserved item to the queue (failure path)."""
        self.kv.delete(_P_RESV + self.name + b"/" + seq.to_bytes(8, "big"))

    def release_stale(self) -> int:
        """Release reservations older than the timeout; returns count
        (reference storage stale-reservation release)."""
        n = 0
        now = _now()
        for k, v in self.kv.iter_prefix(_P_RESV + self.name + b"/"):
            if now - float(v) >= self.timeout:
                self.kv.delete(k)
                n += 1
        return n

    def release_all(self) -> int:
        """Drop every reservation (crash cleanup, reference CleanAllPending)."""
        n = 0
        for k, _ in self.kv.iter_prefix(_P_RESV + self.name + b"/"):
            self.kv.delete(k)
            n += 1
        return n

    def size(self) -> int:
        return len(self.kv.iter_prefix(_P_QUEUE + self.name + b"/"))


class Storage:
    """All pipeline queues + vote statuses + stats for the sequencer."""

    QUEUES = (
        "pending_ballots",
        "verified_ballots",
        "agg_batches",
        "transition_batches",
        "verified_results",
    )

    def __init__(self, kv, reservation_timeout: float = 60.0):
        self.kv = kv
        self.lock = threading.RLock()  # reference storage globalLock role
        for q in self.QUEUES:
            setattr(self, q, Queue(kv, q, reservation_timeout, lock=self.lock))

    # -- vote-ID status machine ---------------------------------------------

    def _status_key(self, process_id: int, vote_id: int) -> bytes:
        return (
            _P_STATUS
            + process_id.to_bytes(32, "big")
            + vote_id.to_bytes(8, "big")
        )

    def set_vote_status(self, process_id: int, vote_id: int, status: VoteIDStatus):
        with self.lock:
            return self._set_vote_status_locked(process_id, vote_id, status)

    def _set_vote_status_locked(self, process_id, vote_id, status):
        key = self._status_key(process_id, vote_id)
        cur = self.kv.get(key)
        if cur is not None:
            cur_s = VoteIDStatus(int(cur))
            if status != cur_s and status not in _VALID_NEXT[cur_s]:
                raise ValueError(f"invalid status transition {cur_s} -> {status}")
        self.kv.put(key, str(int(status)).encode())

    def vote_status(self, process_id: int, vote_id: int) -> VoteIDStatus | None:
        v = self.kv.get(self._status_key(process_id, vote_id))
        return VoteIDStatus(int(v)) if v is not None else None

    # -- per-process stats ---------------------------------------------------

    def bump_stat(self, process_id: int, name: str, delta: int = 1):
        with self.lock:
            key = _P_STATS + process_id.to_bytes(32, "big") + name.encode()
            cur = int(self.kv.get(key) or b"0")
            self.kv.put(key, str(cur + delta).encode())

    def stats(self, process_id: int) -> dict:
        prefix = _P_STATS + process_id.to_bytes(32, "big")
        return {
            k[len(prefix):].decode(): int(v)
            for k, v in self.kv.iter_prefix(prefix)
        }

    # -- generic blobs --------------------------------------------------------

    def put_data(self, name: str, key: bytes, value: bytes):
        self.kv.put(_P_DATA + name.encode() + b"/" + key, value)

    def get_data(self, name: str, key: bytes) -> bytes | None:
        return self.kv.get(_P_DATA + name.encode() + b"/" + key)

    # -- crash recovery -------------------------------------------------------

    def clean_all_pending(self):
        """Release every reservation so a restarted node retries in-flight
        work (reference storage/cleanup.go CleanAllPending)."""
        for q in self.QUEUES:
            getattr(self, q).release_all()
