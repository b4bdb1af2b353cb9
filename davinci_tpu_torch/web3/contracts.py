"""Process-registry contract bindings over JSON-RPC.

Role parity: reference web3/contracts.go + web3/process.go — CreateProcess
(:19), Process (:58), sendProcessTransition (:130, a type-3 blob tx with
the batch sidecar), SetProcessResults (:253), SetProcessStatus (:292),
MonitorProcessUpdates (:367, event polling).  The transport is plain
JSON-RPC (JsonRpcClient / Web3Pool); in this zero-egress environment the
counterparty is web3/fakenode.FakeEthNode, which decodes the SAME wire
bytes — the encoding and flow are the real thing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from davinci_tpu_torch import ethereum as eth
from davinci_tpu_torch import log
from davinci_tpu_torch.web3 import abi
from davinci_tpu_torch.web3.encoding import rlp_encode

# -- contract function/event signatures --------------------------------------

SIG_NEW_PROCESS = (
    "newProcess(uint8,uint256,uint256,uint256,uint256,uint256,uint256,string)"
)  # status, censusOrigin, ballotMode, keyX, keyY, censusRoot, stateRoot, uri
SIG_GET_PROCESS = "getProcess(uint256)"
SIG_NEXT_PID = "getNextProcessId(address)"
SIG_SUBMIT_TRANSITION = "submitStateTransition(uint256,bytes,bytes)"
SIG_SET_RESULTS = "setProcessResults(uint256,bytes,bytes)"
SIG_SET_STATUS = "setProcessStatus(uint256,uint8)"

EV_PROCESS_CREATED = "ProcessCreated(uint256,address)"
EV_STATUS_CHANGED = "ProcessStatusChanged(uint256,uint8)"
EV_ROOT_UPDATED = "ProcessStateRootUpdated(uint256,uint256)"
EV_RESULTS_SET = "ProcessResultsSet(uint256)"

# getProcess return tuple layout
GET_PROCESS_TYPES = [
    "uint8",    # status (0 ready, 1 ended, 2 results)
    "uint256",  # censusOrigin
    "uint256",  # ballotMode
    "uint256",  # encryptionKey.x
    "uint256",  # encryptionKey.y
    "uint256",  # stateRoot
    "uint256",  # censusRoot
    "bytes",    # results (abi uint256[] once set, empty before)
]

STATUS_READY, STATUS_ENDED, STATUS_RESULTS = 0, 1, 2


# -- EIP-1559 type-2 transaction ---------------------------------------------


@dataclass
class Eip1559Tx:
    chain_id: int
    nonce: int
    max_priority_fee: int
    max_fee: int
    gas: int
    to: bytes
    value: int
    data: bytes
    access_list: list = field(default_factory=list)
    v: int = None
    r: int = None
    s: int = None

    def _payload(self):
        return [
            self.chain_id, self.nonce, self.max_priority_fee, self.max_fee,
            self.gas, self.to, self.value, self.data, self.access_list,
        ]

    def signing_hash(self) -> bytes:
        return eth.keccak256(b"\x02" + rlp_encode(self._payload()))

    def encode_signed(self) -> bytes:
        assert self.r is not None
        return b"\x02" + rlp_encode(self._payload() + [self.v, self.r, self.s])

    def tx_hash(self) -> bytes:
        return eth.keccak256(self.encode_signed())


def sign_1559(tx: Eip1559Tx, priv: int) -> Eip1559Tx:
    r, s, rec = eth.sign(priv, tx.signing_hash())
    tx.v, tx.r, tx.s = rec & 1, r, s
    return tx


def sender_of_1559(tx: Eip1559Tx) -> bytes | None:
    pub = eth.recover(tx.signing_hash(), tx.r, tx.s, tx.v)
    return eth.address_from_pubkey(pub) if pub else None


# -- binding ------------------------------------------------------------------


class ProcessRegistry:
    """The process-registry contract binding (reference web3/process.go)."""

    def __init__(self, rpc, address: str, priv: int):
        self.rpc = rpc
        self.address = address
        self.priv = priv
        self.sender = eth.address_from_pubkey(eth.pubkey_from_priv(priv))
        self.chain_id = int(rpc.call("eth_chainId", []), 16)

    # -- tx plumbing ---------------------------------------------------------

    def _nonce(self) -> int:
        return int(
            self.rpc.call(
                "eth_getTransactionCount",
                ["0x" + self.sender.hex(), "pending"],
            ),
            16,
        )

    def _send(self, data: bytes) -> str:
        tx = Eip1559Tx(
            chain_id=self.chain_id, nonce=self._nonce(),
            max_priority_fee=10**9, max_fee=50 * 10**9, gas=3_000_000,
            to=bytes.fromhex(self.address[2:]), value=0, data=data,
        )
        sign_1559(tx, self.priv)
        return self.rpc.call(
            "eth_sendRawTransaction", ["0x" + tx.encode_signed().hex()]
        )

    def _send_blob(self, data: bytes, blobs_with_kzg: list) -> str:
        from davinci_tpu_torch.web3.blobtx import (
            SIDECAR_VERSION_1,
            build_blob_tx,
            sign_blob_tx,
        )

        tx = build_blob_tx(
            chain_id=self.chain_id, nonce=self._nonce(),
            to=bytes.fromhex(self.address[2:]), data=data,
            blobs_with_kzg=blobs_with_kzg,
            sidecar_version=SIDECAR_VERSION_1,
        )
        sign_blob_tx(tx, self.priv)
        return self.rpc.call(
            "eth_sendRawTransaction", ["0x" + tx.encode_network().hex()]
        )

    def _call(self, data: bytes) -> bytes:
        out = self.rpc.call(
            "eth_call", [{"to": self.address, "data": "0x" + data.hex()}, "latest"]
        )
        return bytes.fromhex(out[2:])

    def wait_tx(self, txh: str, timeout: float = 30.0) -> dict:
        import time as _t

        deadline = _t.time() + timeout
        while _t.time() < deadline:
            rcpt = self.rpc.call("eth_getTransactionReceipt", [txh])
            if rcpt:
                if int(rcpt.get("status", "0x0"), 16) != 1:
                    raise RuntimeError(f"tx {txh} reverted")
                return rcpt
            _t.sleep(0.05)
        raise TimeoutError(txh)

    # -- contract methods -----------------------------------------------------

    def next_process_id(self) -> int:
        out = self._call(
            abi.encode_call(SIG_NEXT_PID, ["0x" + self.sender.hex()])
        )
        return abi.decode_args(["uint256"], out)[0]

    def create_process(self, census_origin: int, ballot_mode: int,
                       enc_key: tuple, census_root: int = 0,
                       state_root: int = 0, metadata_uri: str = "") -> int:
        pid = self.next_process_id()
        txh = self._send(
            abi.encode_call(
                SIG_NEW_PROCESS,
                [STATUS_READY, census_origin, ballot_mode,
                 enc_key[0], enc_key[1], census_root, state_root,
                 metadata_uri],
            )
        )
        self.wait_tx(txh)
        log.infow("web3.create_process", pid=pid, tx=txh)
        return pid

    def get_process(self, pid: int) -> dict | None:
        out = self._call(abi.encode_call(SIG_GET_PROCESS, [pid]))
        if not out:
            return None
        (status, census_origin, ballot_mode, kx, ky, state_root,
         census_root, results_raw) = abi.decode_args(GET_PROCESS_TYPES, out)
        results = None
        if results_raw:
            results = abi.decode_args(["uint256[]"], results_raw)[0]
        return {
            "pid": pid, "status": status, "census_origin": census_origin,
            "ballot_mode": ballot_mode, "encryption_key": (kx, ky),
            "state_root": state_root, "census_root": census_root,
            "results": results,
        }

    def submit_state_transition(self, pid: int, proof: bytes, inputs: bytes,
                                blobs_with_kzg: list | None = None) -> str:
        data = abi.encode_call(SIG_SUBMIT_TRANSITION, [pid, proof, inputs])
        if blobs_with_kzg:
            txh = self._send_blob(data, blobs_with_kzg)
        else:
            txh = self._send(data)
        self.wait_tx(txh)
        return txh

    def set_process_results(self, pid: int, proof: bytes, inputs: bytes) -> str:
        txh = self._send(
            abi.encode_call(SIG_SET_RESULTS, [pid, proof, inputs])
        )
        self.wait_tx(txh)
        return txh

    def set_process_status(self, pid: int, status: int) -> str:
        txh = self._send(abi.encode_call(SIG_SET_STATUS, [pid, status]))
        self.wait_tx(txh)
        return txh

    def get_logs(self, from_block: int = 0) -> list:
        """Decoded registry events (reference MonitorProcessUpdates's
        FilterProcessCreated/StatusChanged/StateRootUpdated role)."""
        raw = self.rpc.call(
            "eth_getLogs",
            [{"address": self.address, "fromBlock": hex(from_block)}],
        )
        out = []
        for lg in raw:
            topic0 = bytes.fromhex(lg["topics"][0][2:])
            data = bytes.fromhex(lg["data"][2:])
            blk = int(lg["blockNumber"], 16)
            for name, sig, types in (
                ("created", EV_PROCESS_CREATED, ["uint256", "address"]),
                ("status", EV_STATUS_CHANGED, ["uint256", "uint8"]),
                ("root", EV_ROOT_UPDATED, ["uint256", "uint256"]),
                ("results", EV_RESULTS_SET, ["uint256"]),
            ):
                if topic0 == abi.event_topic(sig):
                    out.append(
                        {"event": name, "block": blk,
                         "args": abi.decode_args(types, data)}
                    )
                    break
        return out


# -- pipeline chain adapter ---------------------------------------------------


class RpcChain:
    """Sequencer chain interface over the ProcessRegistry binding — the
    drop-in replacement for InMemoryChain when a (real or fake) node is
    available (reference sequencer's Contracts dependency)."""

    def __init__(self, registry: ProcessRegistry):
        self.reg = registry
        self.transitions: list = []
        self.blobs: list = []

    # pipeline reads .processes like a dict of ProcessInfo
    @property
    def processes(self) -> dict:
        from davinci_tpu_torch.sequencer.pipeline import ProcessInfo

        out = {}
        for ev in self.reg.get_logs():
            if ev["event"] != "created":
                continue
            pid = ev["args"][0]
            p = self.reg.get_process(pid)
            if p is None:
                continue
            info = ProcessInfo(
                process_id=pid,
                census_origin=p["census_origin"],
                ballot_mode=p["ballot_mode"],
                encryption_key=p["encryption_key"],
                state_root=p["state_root"],
                census_root=p["census_root"],
            )
            info.ended = p["status"] >= STATUS_ENDED
            info.results = p["results"]
            out[pid] = info
        return out

    def create_process(self, info):
        pid = self.reg.create_process(
            info.census_origin, info.ballot_mode, info.encryption_key,
            census_root=info.census_root, state_root=info.state_root,
        )
        assert pid == info.process_id, (pid, info.process_id)

    def process(self, pid: int):
        return self.processes[pid]

    def submit_transition(self, pid, root_before, root_after, proof, blob,
                          sidecar=None):
        inputs = abi.encode_args(
            ["uint256", "uint256"], [root_before, root_after]
        )
        proof_bytes = json.dumps(proof, sort_keys=True).encode()
        blobs_with_kzg = None
        if sidecar is not None:
            # blob arrives as the packed batch hex (pipeline blob_hex)
            blob_bytes = bytes.fromhex(blob)
            commitment = bytes.fromhex(sidecar["commitment"])
            proofs = [bytes.fromhex(p) for p in sidecar["cell_proofs"]]
            blobs_with_kzg = [(blob_bytes, commitment, proofs)]
        try:
            txh = self.reg.submit_state_transition(
                pid, proof_bytes, inputs, blobs_with_kzg
            )
        except (RuntimeError, TimeoutError) as e:
            raise RuntimeError(f"chain: {e}") from e
        self.transitions.append((pid, root_before, root_after, proof))
        self.blobs.append((pid, blob, sidecar))
        return txh

    def end_process(self, pid: int):
        self.reg.set_process_status(pid, STATUS_ENDED)

    def submit_results(self, pid: int, results, proof):
        inputs = abi.encode_args(["uint256[]"], [list(results)])
        proof_bytes = json.dumps(proof, sort_keys=True).encode()
        self.reg.set_process_results(pid, proof_bytes, inputs)
