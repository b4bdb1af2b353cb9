"""Structured logging + phase timing for the node.

Role parity: the reference's zerolog wrapper (log/log.go:100-293) — the
`Infow/Debugw/Warnw/Errorw` key-value API and the `InfoTime`/`DebugTime`
duration helpers used at every proving step (e.g. sequencer/ballot.go:190,
sequencer/statetransition.go:148).

Built on stdlib logging so embedders can re-route handlers; the default
formatter prints one line per event with `key=value` pairs appended, the
way zerolog's console writer does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

_LOGGER_NAME = "davinci"
_logger = logging.getLogger(_LOGGER_NAME)
_initialized = False


class _KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        kv = getattr(record, "kv", None)
        if kv:
            pairs = " ".join(f"{k}={_fmt_val(v)}" for k, v in kv.items())
            return f"{base} {pairs}"
        return base


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, bytes):
        return "0x" + v.hex()
    s = str(v)
    return f'"{s}"' if " " in s else s


def init(level: str | None = None, stream=None) -> None:
    """Initialize the node logger (idempotent).

    Level resolution order: explicit arg > DAVINCI_LOG_LEVEL env > info.
    Matches the reference's log.Init(cfg.LogLevel, ...) entrypoint
    (cmd/davinci-sequencer/main.go via log/log.go:157).
    """
    global _initialized
    lvl = (level or os.environ.get("DAVINCI_LOG_LEVEL") or "info").upper()
    if _initialized:
        _logger.setLevel(getattr(logging, lvl, logging.INFO))
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(
        _KVFormatter("%(asctime)s %(levelname).3s %(message)s", "%H:%M:%S")
    )
    _logger.addHandler(handler)
    _logger.setLevel(getattr(logging, lvl, logging.INFO))
    _logger.propagate = False
    _initialized = True


def _log(level: int, msg: str, kv: dict) -> None:
    if not _initialized:
        init()
    _logger.log(level, msg, extra={"kv": kv})


def debugw(msg: str, **kv) -> None:
    _log(logging.DEBUG, msg, kv)


def infow(msg: str, **kv) -> None:
    _log(logging.INFO, msg, kv)


def warnw(msg: str, **kv) -> None:
    _log(logging.WARNING, msg, kv)


def errorw(msg: str, **kv) -> None:
    _log(logging.ERROR, msg, kv)


@contextlib.contextmanager
def info_time(msg: str, **kv):
    """Context manager logging `msg` with the elapsed wall time on exit —
    the reference's log.InfoTime discipline (log/log.go:270-293) around
    every prove/MSM/NTT phase."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        _log(logging.INFO, msg, {**kv, "took_s": round(dt, 4)})


@contextlib.contextmanager
def debug_time(msg: str, **kv):
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        _log(logging.DEBUG, msg, {**kv, "took_s": round(dt, 4)})
