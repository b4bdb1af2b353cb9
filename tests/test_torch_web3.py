"""The on-chain rim (`web3/`, verbatim copies) against the reference, on
the vectors of the reference's tests/test_web3.py and
test_web3_bindings.py: RLP, ABI and selectors, EIP-1559 and EIP-4844
transactions (versions 0 and 1 of the sidecar) signed to the same bytes,
the `TxManager`'s fee escalation, the proof calldata, a Solidity
verifier exported from one verifying key, and the seeded election of
test_web3_bindings.py over `RpcChain` against each package's
`FakeEthNode` (served on 127.0.0.1), which must post the reference's
transactions, in its order, and settle the same results.
"""

import importlib
import random

import pytest
import torch

torch.set_num_threads(1)

PKGS = ("davinci_tpu_torch", "davinci_tpu")
PRIV = 0x51EA1ED0C0FFEE0DDF00DBA5EBA11AD11B17E5C0DE5EED5EA15EEDBEEFCAFE1
BLOB = b"\x00" * 131072


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(fn):
    """fn(pkg) in the port and in the reference."""
    return [fn(pkg) for pkg in PKGS]


def encodings(pkg):
    enc = _mod(pkg, "web3.encoding")
    abi = _mod(pkg, "web3.abi")
    K = _mod(pkg, "web3.contracts")
    items = [b"", b"\x00", b"dog", [], [b"cat", b"dog"], 0, 15, 1024,
             b"a" * 56, [[], [[]], [b"x" * 60, 2**64]]]
    out = {"rlp": [enc.rlp_encode(i) for i in items]}
    out["rlp_back"] = [enc.rlp_decode(enc.rlp_encode(i)) for i in items[1:]]
    out["selectors"] = [enc.function_selector(s) for s in (
        "transfer(address,uint256)", "baz(uint32,bool)", K.SIG_NEW_PROCESS,
        K.SIG_SUBMIT_TRANSITION, K.SIG_SET_RESULTS, K.SIG_SET_STATUS)]
    out["abi"] = [enc.abi_encode(["uint32", "bool"], [69, True]),
                  enc.abi_encode(["bytes"], [b"abc"]),
                  enc.abi_encode(["uint256[]"], [[1, 2]]),
                  enc.encode_call("submit((uint256,uint256),bytes32)",
                                  [["uint256", "uint256"], "bytes32"],
                                  [(1, 2), b"\x11" * 32])]
    call = abi.encode_call(K.SIG_NEW_PROCESS,
                           [K.STATUS_READY, 1, 7, 11, 22, 33, 44, "ipfs://x"])
    out["contract"] = [call, abi.decode_args(abi.sig_types(K.SIG_NEW_PROCESS),
                                             call[4:]),
                       abi.event_topic(K.EV_ROOT_UPDATED)]
    return out


def test_encodings_equal_the_reference():
    port, ref = both(encodings)
    assert port == ref
    assert port["rlp"][:4] == [b"\x80", b"\x00", b"\x83dog", b"\xc0"]
    assert port["selectors"][0].hex() == "a9059cbb"


def transactions(pkg):
    eth = _mod(pkg, "ethereum")
    blobtx = _mod(pkg, "web3.blobtx")
    K = _mod(pkg, "web3.contracts")
    tx0 = blobtx.build_blob_tx(chain_id=1, nonce=7, to=b"\x22" * 20,
                               data=b"\xde\xad",
                               blobs_with_kzg=[(BLOB, b"\x01" * 48,
                                                b"\x02" * 48)])
    blobtx.sign_blob_tx(tx0, 0xA11CE)
    cells = [bytes([i]) * 48 for i in range(blobtx.CELL_PROOFS_PER_BLOB)]
    tx1 = blobtx.build_blob_tx(chain_id=1, nonce=1, to=b"\x22" * 20, data=b"",
                               blobs_with_kzg=[(BLOB, b"\x01" * 48, cells)],
                               sidecar_version=1)
    blobtx.sign_blob_tx(tx1, 0xB0B)
    tx1.validate_sidecar()
    tx2 = K.Eip1559Tx(chain_id=31337, nonce=3, max_priority_fee=10**9,
                      max_fee=50 * 10**9, gas=3_000_000, to=b"\xda\x71" * 10,
                      value=0, data=b"\x01\x02")
    K.sign_1559(tx2, PRIV)
    short = blobtx.build_blob_tx(chain_id=1, nonce=1, to=b"\x22" * 20,
                                 data=b"", blobs_with_kzg=[(BLOB, b"\x01" * 48,
                                                            cells[:-1])],
                                 sidecar_version=1)
    with pytest.raises(ValueError):
        short.validate_sidecar()
    return {
        "v0": [tx0.encode_signed(), tx0.encode_network(),
               tx0.blob_versioned_hashes, blobtx.sender_of(tx0)],
        "v1": [tx1.encode_signed(), tx1.encode_network()],
        "1559": [tx2.encode_signed(), tx2.tx_hash(), K.sender_of_1559(tx2)],
        "senders": [eth.address_from_pubkey(eth.pubkey_from_priv(k))
                    for k in (0xA11CE, PRIV)],
    }


def test_transactions_equal_the_reference():
    port, ref = both(transactions)
    assert port == ref
    assert port["v0"][0][0] == 3 and port["v0"][2][0][0] == 1
    assert port["v1"][1][:2] == b"\x03\x01"
    assert port["v0"][3] == port["senders"][0]
    assert port["1559"][2] == port["senders"][1]


class FakeRPC:
    """Confirms on the `confirm_after`-th receipt poll, whatever the hash
    (tests/test_web3.py's)."""

    def __init__(self, keccak, confirm_after):
        self.keccak, self.confirm_after = keccak, confirm_after
        self.sent, self.polls = [], 0

    def nonce(self, addr):
        return 5

    def send_raw(self, raw):
        h = "0x" + self.keccak(raw).hex()
        self.sent.append(h)
        return h

    def receipt(self, tx_hash):
        self.polls += 1
        return {"status": "0x1"} if self.polls >= self.confirm_after else None


def escalation(pkg):
    txmanager = _mod(pkg, "web3.txmanager")
    out = {}
    for tx_id, confirm_after, max_fee in (("t1", 3, 10**9),
                                          ("t2", 10**9, 200 * 10**9)):
        rpc = FakeRPC(_mod(pkg, "ethereum").keccak256, confirm_after)
        fees, done = [], []
        tm = txmanager.TxManager(rpc, "0xsender", retry_after=0.0)
        tm.submit(tx_id,
                  build=lambda nonce, fee: fees.append((nonce, fee))
                  or fee.to_bytes(16, "big"),
                  on_confirmed=lambda rec: done.append("confirmed"),
                  on_failed=lambda e: done.append(e), max_fee=max_fee)
        for _ in range(20):
            tm.tick()
        out[tx_id] = [fees, rpc.sent, done]
    return out


def test_txmanager_escalates_as_the_reference():
    port, ref = both(escalation)
    assert port == ref
    fees, _, done = port["t1"]
    assert done == ["confirmed"] and fees[1][1] == fees[0][1] * 3 // 2
    assert port["t2"][2] == ["max retries exceeded"]


def synthetic_vk_and_proof(pkg, n_public=2):
    """A BN254 verifying key from known trapdoors (alpha, beta, gamma,
    delta and the K's discrete logs) and a proof for `publics` made with
    them: A = a G1, B = b G2, C = c G1 with ab = alpha beta + gamma
    sum(x_i k_i) + delta c."""
    C = _mod(pkg, "curves")
    core = _mod(pkg, "groth16.core")
    r = C.bn254_g1.r
    rng = random.Random(0x50115)
    al, be, ga, de, a, b = (rng.randrange(1, r) for _ in range(6))
    ks = [rng.randrange(1, r) for _ in range(n_public + 1)]
    g1, g2 = C.bn254_g1.gen, C.bn254_g2.gen
    vk = core.VerifyingKey(alpha_g1=g1.mul(al), beta_g2=g2.mul(be),
                           gamma_g2=g2.mul(ga), delta_g2=g2.mul(de),
                           k_pub_g1=[g1.mul(k) for k in ks])
    publics = [rng.randrange(r) for _ in range(n_public)]
    acc = (ks[0] + sum(x * k for x, k in zip(publics, ks[1:]))) % r
    c = (a * b - al * be - ga * acc) * pow(de, -1, r) % r
    proof = core.Proof(a=g1.mul(a), b=g2.mul(b), c=g1.mul(c))
    return vk, proof, publics


def solidity(pkg):
    sol = _mod(pkg, "web3.solidity_export")
    enc = _mod(pkg, "web3.encoding")
    vk, proof, publics = synthetic_vk_and_proof(pkg)
    src = sol.export_solidity_verifier(vk, name="results-verifier")
    words = enc.groth16_proof_tuple(proof)
    bad = list(words)
    bad[0] = (bad[0] + 1) % 2**256
    return {"source": src, "calldata": enc.encode_proof_calldata(proof,
                                                                 publics),
            "replays": [sol.replay_verifier_source(src, words, publics),
                        sol.replay_verifier_source(
                            src, words, [publics[0] + 1] + publics[1:]),
                        sol.replay_verifier_source(src, bad, publics)]}


def test_solidity_verifier_equals_the_reference():
    port, ref = both(solidity)
    assert port == ref
    assert "contract VerifierResultsVerifier" in port["source"]
    assert port["replays"] == [True, False, False]


def rpc_election(pkg):
    """The seeded election of test_web3_bindings.py over `RpcChain` and
    package `pkg`'s `FakeEthNode`, then a blob transaction with a
    version-1 sidecar: the node's transaction hashes in order, its logs,
    the process as the registry holds it and the vote statuses."""
    spec = _mod(pkg, "spec")
    elgamal = _mod(pkg, "elgamal")
    pipeline = _mod(pkg, "sequencer.pipeline")
    storage = _mod(pkg, "storage")
    K = _mod(pkg, "web3.contracts")
    abi = _mod(pkg, "web3.abi")
    node = _mod(pkg, "web3.fakenode").FakeEthNode()
    server = node.serve()
    try:
        rpc = _mod(pkg, "web3.rpc").JsonRpcClient(
            f"http://127.0.0.1:{server.server_address[1]}/")
        reg = K.ProcessRegistry(rpc, node.REGISTRY_ADDR, PRIV)
        chain = K.RpcChain(reg)
        r = random.Random(5)
        pub, priv = elgamal.generate_key(r)
        pid = 1
        info = pipeline.ProcessInfo(
            process_id=pid, census_origin=1, ballot_mode=0,
            encryption_key=(pub.x, pub.y),
            state_root=spec.state_root(pid, 1, pub.x, pub.y, 0))
        chain.create_process(info)
        seq = pipeline.Sequencer(storage.Storage(storage.MemoryKV()), chain,
                                 batch_time_window=0.0, max_dl_bound=1 << 8)
        seq.register_process(info, priv_key=priv)
        vids = []
        for _ in range(2):
            b = elgamal.Ballot.encrypt([1, 0, 0, 0, 0, 0, 0, 0], pub,
                                       r.randrange(1, 2**200))
            vid = spec.VOTE_ID_MIN + r.randrange(2**40)
            seq.submit_ballot(pid, r.randrange(2**160), b, vid)
            vids.append(vid)
        seq.tick_ballot()
        seq.tick_aggregate()
        seq.tick_transition(rng=r)
        seq.tick_onchain()
        settled = [int(seq.storage.vote_status(pid, v)) for v in vids]
        root = seq.states[pid].root
        chain.end_process(pid)
        seq.tick_finalizer(rng=r)
        # a second process whose transition carries a blob (version 1: the
        # compressed point at infinity as commitment and proofs)
        pid2 = reg.create_process(1, 0, (1, 2), state_root=10)
        point = bytes([0xC0]) + b"\x00" * 47
        inputs = abi.encode_args(["uint256", "uint256"], [10, 20])
        reg.submit_state_transition(pid2, b"pf", inputs,
                                    [(BLOB, point, [point] * 128)])
        with pytest.raises(RuntimeError):  # wrong blob size: reverted
            reg.submit_state_transition(
                pid2, b"pf", abi.encode_args(["uint256", "uint256"], [20, 30]),
                [(BLOB[:-32], point, [point] * 128)])
        return {"txs": list(node.receipts),
                "statuses": [rc["status"] for rc in node.receipts.values()],
                "logs": node.logs, "process": reg.get_process(pid),
                "blob_process": reg.get_process(pid2),
                "settled": settled, "root": root,
                "events": [e["event"] for e in reg.get_logs()]}
    finally:
        server.shutdown()


def test_election_over_rpc_chain_posts_the_reference_transactions():
    port, ref = both(rpc_election)
    assert port == ref
    K = _mod("davinci_tpu_torch", "web3.contracts")
    assert port["settled"] == [4, 4]  # SETTLED
    assert port["process"]["state_root"] == port["root"]
    assert port["process"]["status"] == K.STATUS_RESULTS
    assert port["process"]["results"] == [2, 0, 0, 0, 0, 0, 0, 0]
    assert port["blob_process"]["state_root"] == 20
    assert port["statuses"] == ["0x1"] * (len(port["txs"]) - 1) + ["0x0"]
    assert port["events"] == ["created", "root", "status", "results",
                              "created", "root"]
