"""JSON-RPC client + multi-endpoint pool.

Role parity: reference web3/rpc/ (Web3Pool with endpoint health rotation)
— urllib-based (no external HTTP deps); fully injectable for tests (and
for this zero-egress build environment).
"""

from __future__ import annotations

import json
import time
import urllib.request


class JsonRpcClient:
    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        req = urllib.request.Request(
            self.url,
            data=json.dumps(
                {
                    "jsonrpc": "2.0",
                    "id": self._id,
                    "method": method,
                    "params": params,
                }
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RuntimeError(f"rpc error: {out['error']}")
        return out["result"]


class Web3Pool:
    """Rotates across endpoints, demoting failing ones for a cooldown
    (reference web3/rpc Web3Pool)."""

    def __init__(self, clients: list, cooldown: float = 60.0):
        assert clients
        self.clients = list(clients)
        self.cooldown = cooldown
        self.banned_until: dict[int, float] = {}

    def _usable(self):
        now = time.time()
        return [
            (i, c)
            for i, c in enumerate(self.clients)
            if self.banned_until.get(i, 0) <= now
        ] or list(enumerate(self.clients))

    def call(self, method: str, params: list):
        last = None
        for i, c in self._usable():
            try:
                return c.call(method, params)
            except Exception as e:  # demote and try next
                self.banned_until[i] = time.time() + self.cooldown
                last = e
        raise RuntimeError(f"all endpoints failed: {last}")

    # convenience wrappers the node uses
    def chain_id(self) -> int:
        return int(self.call("eth_chainId", []), 16)

    def nonce(self, address: str) -> int:
        return int(self.call("eth_getTransactionCount", [address, "pending"]), 16)

    def gas_price(self) -> int:
        return int(self.call("eth_gasPrice", []), 16)

    def send_raw(self, raw: bytes) -> str:
        return self.call("eth_sendRawTransaction", ["0x" + raw.hex()])

    def receipt(self, tx_hash: str):
        return self.call("eth_getTransactionReceipt", [tx_hash])
