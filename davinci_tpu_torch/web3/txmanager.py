"""TxManager: nonce tracking, pending-tx monitoring, fee-escalating
rebroadcast with callback-driven settlement.

Role parity: reference web3/txmanager/ (txmanager.go:23-62: monitor pending
txs, rebroadcast with +50% fee up to 10 retries, 300 gwei cap, nonce
resets; callbacks promote/roll back sequencer batches,
sequencer/onchain.go:208-279)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

FEE_BUMP_NUM, FEE_BUMP_DEN = 3, 2      # +50%
MAX_RETRIES = 10
MAX_FEE_CAP = 300 * 10**9              # 300 gwei


@dataclass
class PendingTx:
    tx_id: str
    build: callable        # (nonce, max_fee) -> raw bytes
    on_confirmed: callable
    on_failed: callable
    nonce: int
    max_fee: int
    retries: int = 0
    sent_at: float = 0.0
    tx_hash: str = ""


class TxManager:
    def __init__(self, rpc, sender: str, retry_after: float = 30.0):
        self.rpc = rpc
        self.sender = sender
        self.retry_after = retry_after
        self.pending: dict[str, PendingTx] = {}
        self._nonce: int | None = None

    def _next_nonce(self) -> int:
        chain_nonce = self.rpc.nonce(self.sender)
        if self._nonce is None or chain_nonce > self._nonce:
            self._nonce = chain_nonce
        n = self._nonce
        self._nonce += 1
        return n

    def reset_nonce(self):
        """Reference txmanager nonce-reset path."""
        self._nonce = None

    def submit(self, tx_id, build, on_confirmed, on_failed, max_fee=20 * 10**9):
        nonce = self._next_nonce()
        p = PendingTx(tx_id, build, on_confirmed, on_failed, nonce, max_fee)
        self._broadcast(p)
        self.pending[tx_id] = p

    def _broadcast(self, p: PendingTx):
        raw = p.build(p.nonce, p.max_fee)
        p.tx_hash = self.rpc.send_raw(raw)
        p.sent_at = time.time()

    def tick(self):
        """Poll receipts; escalate or fail timed-out txs."""
        for tx_id in list(self.pending):
            p = self.pending[tx_id]
            rec = self.rpc.receipt(p.tx_hash)
            if rec is not None:
                del self.pending[tx_id]
                if int(rec.get("status", "0x0"), 16) == 1:
                    p.on_confirmed(rec)
                else:
                    p.on_failed("reverted")
                continue
            if time.time() - p.sent_at < self.retry_after:
                continue
            # escalate
            p.retries += 1
            if p.retries > MAX_RETRIES:
                del self.pending[tx_id]
                p.on_failed("max retries exceeded")
                continue
            p.max_fee = min(p.max_fee * FEE_BUMP_NUM // FEE_BUMP_DEN, MAX_FEE_CAP)
            try:
                self._broadcast(p)
            except Exception:
                pass  # next tick retries again
