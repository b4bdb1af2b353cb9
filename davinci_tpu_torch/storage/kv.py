"""Key-value backends: in-memory (tests) and sqlite (persistent).

Role parity: reference db/ (db.Database interface with pebble/goleveldb/
inmemory backends, db/metadb factory).  The node's durability model is
persistent-by-construction: every queue and status lives in the KV, so a
restarted node resumes from disk (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import sqlite3
import threading


class MemoryKV:
    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._d.get(key)

    def put(self, key: bytes, value: bytes):
        with self._lock:
            self._d[key] = value

    def delete(self, key: bytes):
        with self._lock:
            self._d.pop(key, None)

    def iter_prefix(self, prefix: bytes):
        """Yields (key, value) sorted by key."""
        with self._lock:
            keys = sorted(k for k in self._d if k.startswith(prefix))
            return [(k, self._d[k]) for k in keys]

    def close(self):
        pass


class SQLiteKV:
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)"
        )
        self._conn.commit()
        self._lock = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)
            ).fetchone()
            return row[0] if row else None

    def put(self, key: bytes, value: bytes):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value)
            )
            self._conn.commit()

    def delete(self, key: bytes):
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def iter_prefix(self, prefix: bytes):
        hi = prefix + b"\xff" * 8
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k <= ? ORDER BY k",
                (prefix, hi),
            ).fetchall()
            return [(bytes(k), bytes(v)) for k, v in rows]

    def close(self):
        self._conn.close()
