"""In-process fake Ethereum node hosting the process-registry contract.

Role parity: the live chain the reference's web3 bindings talk to
(web3/contracts.go against Sepolia) — here a local JSON-RPC server that
DECODES the exact wire bytes the bindings produce (typed txs incl. the
EIP-4844 sidecar form, ABI calldata), enforces the registry's state
machine, and serves eth_call/eth_getLogs.  Zero-egress stand-in that
keeps the encoding and flow real; a live endpoint drops in by URL.
"""

from __future__ import annotations

import json
import threading

from davinci_tpu_torch import ethereum as eth
from davinci_tpu_torch import log
from davinci_tpu_torch.web3 import abi
from davinci_tpu_torch.web3 import contracts as K
from davinci_tpu_torch.web3.blobtx import (
    BLOB_TX_TYPE,
    CELL_PROOFS_PER_BLOB,
    SIDECAR_VERSION_1,
)
from davinci_tpu_torch.blobs import versioned_hash
from davinci_tpu_torch.web3.encoding import rlp_decode


def _i(b: bytes) -> int:
    return int.from_bytes(b, "big")


class Revert(Exception):
    pass


class Registry:
    """The process-registry contract state machine."""

    def __init__(self):
        self.next_pid = 1
        self.processes: dict[int, dict] = {}

    # view calls ------------------------------------------------------------

    def call(self, data: bytes) -> bytes:
        sel, args = data[:4], data[4:]
        if sel == abi.selector(K.SIG_NEXT_PID):
            return abi.encode_args(["uint256"], [self.next_pid])
        if sel == abi.selector(K.SIG_GET_PROCESS):
            (pid,) = abi.decode_args(["uint256"], args)
            p = self.processes.get(pid)
            if p is None:
                return b""
            results_raw = (
                abi.encode_args(["uint256[]"], [p["results"]])
                if p["results"] is not None
                else b""
            )
            return abi.encode_args(
                K.GET_PROCESS_TYPES,
                [p["status"], p["census_origin"], p["ballot_mode"],
                 p["key"][0], p["key"][1], p["state_root"],
                 p["census_root"], results_raw],
            )
        raise Revert("unknown view selector")

    # transactions -----------------------------------------------------------

    def execute(self, sender: bytes, data: bytes, node, blob_hashes=None):
        sel, args = data[:4], data[4:]
        if sel == abi.selector(K.SIG_NEW_PROCESS):
            (status, origin, bm, kx, ky, croot, sroot,
             _uri) = abi.decode_args(abi.sig_types(K.SIG_NEW_PROCESS), args)
            pid = self.next_pid
            self.next_pid += 1
            self.processes[pid] = {
                "status": status, "census_origin": origin,
                "ballot_mode": bm, "key": (kx, ky), "state_root": sroot,
                "census_root": croot, "results": None,
            }
            node.emit_log(K.EV_PROCESS_CREATED, ["uint256", "address"],
                          [pid, _i(sender)])
            return
        if sel == abi.selector(K.SIG_SUBMIT_TRANSITION):
            pid, _proof, inputs = abi.decode_args(
                abi.sig_types(K.SIG_SUBMIT_TRANSITION), args
            )
            root_before, root_after = abi.decode_args(
                ["uint256", "uint256"], inputs
            )
            p = self.processes.get(pid)
            if p is None:
                raise Revert("no such process")
            if p["status"] != K.STATUS_READY:
                raise Revert("process not accepting transitions")
            if p["state_root"] != root_before:
                raise Revert("root mismatch")
            p["state_root"] = root_after
            node.emit_log(K.EV_ROOT_UPDATED, ["uint256", "uint256"],
                          [pid, root_after])
            return
        if sel == abi.selector(K.SIG_SET_STATUS):
            pid, status = abi.decode_args(
                abi.sig_types(K.SIG_SET_STATUS), args
            )
            p = self.processes.get(pid)
            if p is None:
                raise Revert("no such process")
            if status < p["status"]:
                raise Revert("status cannot regress")
            p["status"] = status
            node.emit_log(K.EV_STATUS_CHANGED, ["uint256", "uint8"],
                          [pid, status])
            return
        if sel == abi.selector(K.SIG_SET_RESULTS):
            pid, _proof, inputs = abi.decode_args(
                abi.sig_types(K.SIG_SET_RESULTS), args
            )
            p = self.processes.get(pid)
            if p is None:
                raise Revert("no such process")
            if p["status"] != K.STATUS_ENDED:
                raise Revert("process not ended")
            (results,) = abi.decode_args(["uint256[]"], inputs)
            p["results"] = results
            p["status"] = K.STATUS_RESULTS
            node.emit_log(K.EV_RESULTS_SET, ["uint256"], [pid])
            return
        raise Revert("unknown selector")


class FakeEthNode:
    """JSON-RPC backend: typed-tx decoding + the registry contract."""

    REGISTRY_ADDR = "0x" + "da71" * 10

    def __init__(self, chain_id: int = 31337):
        self.chain_id = chain_id
        self.registry = Registry()
        self.block = 1
        self.nonces: dict[str, int] = {}
        self.receipts: dict[str, dict] = {}
        self.logs: list[dict] = []
        self._lock = threading.Lock()

    # -- log + tx machinery ---------------------------------------------------

    def emit_log(self, sig: str, types: list, values: list):
        self.logs.append(
            {
                "address": self.REGISTRY_ADDR,
                "topics": ["0x" + abi.event_topic(sig).hex()],
                "data": "0x" + abi.encode_args(types, values).hex(),
                "blockNumber": hex(self.block),
            }
        )

    def _decode_raw_tx(self, raw: bytes):
        """-> (sender, to, data, nonce, blob_versioned_hashes|None)."""
        ttype = raw[0]
        if ttype == 0x02:
            fields = rlp_decode(raw[1:])
            (cid, nonce, tip, fee, gas, to, value, data, al, v, r, s) = fields
            tx = K.Eip1559Tx(
                chain_id=_i(cid), nonce=_i(nonce), max_priority_fee=_i(tip),
                max_fee=_i(fee), gas=_i(gas), to=to, value=_i(value),
                data=data, access_list=al, v=_i(v), r=_i(r), s=_i(s),
            )
            sender = K.sender_of_1559(tx)
            return sender, to, data, _i(nonce), None
        if ttype == BLOB_TX_TYPE:
            from davinci_tpu_torch.web3.blobtx import BlobTx

            body = raw[1:]
            version = 0
            if body[0] == SIDECAR_VERSION_1:
                version, body = SIDECAR_VERSION_1, body[1:]
            payload, blobs, commitments, proofs = rlp_decode(body)
            (cid, nonce, tip, fee, gas, to, value, data, al, bfee,
             bhashes, v, r, s) = payload
            tx = BlobTx(
                chain_id=_i(cid), nonce=_i(nonce), max_priority_fee=_i(tip),
                max_fee=_i(fee), gas=_i(gas), to=to, value=_i(value),
                data=data, max_fee_per_blob_gas=_i(bfee),
                blob_versioned_hashes=list(bhashes), access_list=al,
                v=_i(v), r=_i(r), s=_i(s), blobs=blobs,
                commitments=commitments, proofs=proofs,
                sidecar_version=version,
            )
            from davinci_tpu_torch.web3.blobtx import sender_of

            sender = sender_of(tx)
            # consensus-side sidecar validation
            tx.validate_sidecar()
            if version == SIDECAR_VERSION_1 and len(proofs) != len(
                blobs
            ) * CELL_PROOFS_PER_BLOB:
                raise Revert("cell proof count")
            for blob, c, h in zip(blobs, commitments, bhashes):
                if len(blob) != 4096 * 32:
                    raise Revert("blob size")
                if versioned_hash(c) != h:
                    raise Revert("versioned hash mismatch")
            return sender, to, data, _i(nonce), list(bhashes)
        raise Revert(f"unsupported tx type {ttype}")

    # -- JSON-RPC dispatch ----------------------------------------------------

    def handle(self, method: str, params: list):
        with self._lock:
            return self._handle(method, params)

    def _handle(self, method: str, params: list):
        if method == "eth_chainId":
            return hex(self.chain_id)
        if method == "eth_blockNumber":
            return hex(self.block)
        if method == "eth_getTransactionCount":
            return hex(self.nonces.get(params[0].lower(), 0))
        if method == "eth_sendRawTransaction":
            raw = bytes.fromhex(params[0][2:])
            txh = "0x" + eth.keccak256(raw).hex()
            status = "0x1"
            try:
                sender, to, data, nonce, bh = self._decode_raw_tx(raw)
                if sender is None:
                    raise Revert("bad signature")
                skey = "0x" + sender.hex()
                if nonce != self.nonces.get(skey.lower(), 0):
                    raise Revert("bad nonce")
                self.nonces[skey.lower()] = nonce + 1
                if "0x" + to.hex() != self.REGISTRY_ADDR:
                    raise Revert("unknown contract")
                self.registry.execute(sender, data, self, bh)
            except Revert as e:
                log.debugw("fakenode.revert", err=str(e))
                status = "0x0"
            self.block += 1
            self.receipts[txh] = {
                "status": status,
                "blockNumber": hex(self.block - 1),
                "transactionHash": txh,
            }
            return txh
        if method == "eth_getTransactionReceipt":
            return self.receipts.get(params[0])
        if method == "eth_call":
            to = params[0]["to"]
            data = bytes.fromhex(params[0]["data"][2:])
            if to != self.REGISTRY_ADDR:
                raise Revert("unknown contract")
            try:
                return "0x" + self.registry.call(data).hex()
            except Revert:
                return "0x"
        if method == "eth_getLogs":
            flt = params[0]
            frm = int(flt.get("fromBlock", "0x0"), 16)
            addr = flt.get("address")
            return [
                lg for lg in self.logs
                if int(lg["blockNumber"], 16) >= frm
                and (addr is None or lg["address"] == addr)
            ]
        raise ValueError(f"unsupported method {method}")

    # -- HTTP transport -------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        import http.server

        node = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"]))
                )
                try:
                    out = {
                        "jsonrpc": "2.0", "id": body["id"],
                        "result": node.handle(body["method"], body["params"]),
                    }
                except Exception as e:  # rpc-level error
                    out = {
                        "jsonrpc": "2.0", "id": body["id"],
                        "error": {"code": -32000, "message": str(e)},
                    }
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        server = http.server.ThreadingHTTPServer((host, port), H)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
