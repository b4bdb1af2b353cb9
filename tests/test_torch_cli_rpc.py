"""The node's entry points that speak JSON-RPC (`cli.py`, a verbatim copy)
of davinci_tpu_torch held against the JAX package's on the CPU, through
`cli.main` as tests/torch_cli_cases.py drives it.

* `e2e --votes 4 --rpc-chain`: the election over the contract bindings
  and a local `FakeEthNode` of the package's own; the JSON line equals
  the reference's but for `seconds`.
* `send-blob -n 1 --wait` against the local fake RPC of
  tests/test_send_blob.py: the signed EIP-4844 transaction each package
  submits is the same bytes.  Its commitment and proof are 4,096-point
  MSMs; here both packages' `kzg._g1_msm` is one host stand-in (the
  generator times the scalars' sum), so the case holds the blob, the
  transaction's encoding and signature and the RPC flow; with
  RUN_SLOW_TESTS the same case runs the real MSMs (the port's plain MSM
  on CPU tensors) and the bytes must still be equal.

Tolerance: exact equality of JSON values and bytes.
"""

import http.server
import json
import os
import threading

import pytest
import torch

from torch_cli_cases import PORT, REF, e2e_matches_reference, mod, run_cli

torch.set_num_threads(1)


def test_e2e_rpc_chain_matches_reference(capsys, monkeypatch):
    e2e_matches_reference(["e2e", "--votes", "4", "--rpc-chain"], capsys,
                          monkeypatch)


class FakeRpc:
    """tests/test_send_blob.py's fake endpoint: chain 31337, nonce 7."""

    def __init__(self):
        self.raw_txs = []

    def handle(self, method, params):
        if method == "eth_chainId":
            return hex(31337)
        if method == "eth_getTransactionCount":
            return hex(7)
        if method == "eth_sendRawTransaction":
            self.raw_txs.append(bytes.fromhex(params[0][2:]))
            return "0x" + "ab" * 32
        if method == "eth_getTransactionReceipt":
            return {"status": "0x1"}
        raise ValueError(method)


def _serve(fake):
    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            data = json.dumps({"jsonrpc": "2.0", "id": body["id"],
                               "result": fake.handle(body["method"],
                                                     body["params"])})
            data = data.encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


PRIV = 0xA1B2C3D4E5F60718293A4B5C6D7E8F90A1B2C3D4E5F60718293A4B5C6D7E8F9


def _send_blob(pkg, capsys, monkeypatch, real_msm):
    kzg = mod(pkg, "blobs.kzg")
    if not real_msm:
        g1 = mod(pkg, "curves").bls381_g1
        monkeypatch.setattr(kzg, "_g1_msm", lambda scalars, *a: g1.gen.mul(
            sum(scalars) % kzg.R))
    elif pkg == PORT:  # the port's plain MSM on CPU tensors
        card = kzg._g1_msm
        monkeypatch.setattr(kzg, "_g1_msm",
                            lambda scalars, device="cuda": card(scalars, "cpu"))
    fake = FakeRpc()
    server = _serve(fake)
    try:
        out = run_cli(pkg, ["send-blob", "--rpc",
                            f"http://127.0.0.1:{server.server_address[1]}/",
                            "--privkey", hex(PRIV), "-n", "1", "--wait"],
                      capsys, monkeypatch)
    finally:
        server.shutdown()
        server.server_close()
    return out, fake.raw_txs


@pytest.mark.parametrize("real_msm", [
    False,
    pytest.param(True, marks=pytest.mark.skipif(
        not os.environ.get("RUN_SLOW_TESTS"),
        reason="four 4,096-point MSMs on the CPU: minutes")),
])
def test_send_blob_matches_reference(real_msm, capsys, monkeypatch):
    got, got_txs = _send_blob(PORT, capsys, monkeypatch, real_msm)
    want, want_txs = _send_blob(REF, capsys, monkeypatch, real_msm)
    assert got == want and got_txs == want_txs
    eth = mod(PORT, "ethereum")
    sender = eth.address_from_pubkey(eth.pubkey_from_priv(PRIV))
    assert got["from"] == "0x" + sender.hex() and got["status"] == "0x1"
    [raw] = got_txs
    assert raw[0] == 0x03  # EIP-4844
