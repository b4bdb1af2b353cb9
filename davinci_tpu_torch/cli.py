"""CLI entrypoints.

Role parity: reference cmd/ (davinci-sequencer main binary, cmd/e2e-test
synthetic election, cmd/cli client).  Usage:

  python -m davinci_tpu_torch.cli sequencer --db /tmp/davinci.db --port 8080
  python -m davinci_tpu_torch.cli e2e --votes 5
  python -m davinci_tpu_torch.cli worker --master http://host:8080 --name w1
"""

from __future__ import annotations

import argparse
import json
import random
import threading
import time


def cmd_sequencer(args):
    from davinci_tpu_torch.api import API, serve
    from davinci_tpu_torch.census import CensusDB
    from davinci_tpu_torch.sequencer import InMemoryChain, Sequencer
    from davinci_tpu_torch.storage import MemoryKV, SQLiteKV, Storage
    from davinci_tpu_torch.workers import JobsManager, WorkerManager

    kv = SQLiteKV(args.db) if args.db else MemoryKV()
    storage = Storage(kv)
    storage.clean_all_pending()  # crash recovery (reference --forceCleanup)
    chain = InMemoryChain()
    seq = Sequencer(storage, chain, batch_time_window=args.batch_window)
    jm = JobsManager(storage, WorkerManager(args.worker_seed)) if args.worker_seed else None
    api = API(seq, CensusDB(), jobs_manager=jm)
    server, _ = serve(api, port=args.port)
    print(f"davinci-tpu sequencer listening on :{server.server_address[1]}")

    def ticker():
        while True:
            try:
                seq.tick_ballot()
                seq.tick_aggregate()
                seq.tick_transition()
                seq.tick_onchain()
                seq.tick_finalizer()
            except Exception as e:
                print("tick error:", e)
            time.sleep(args.tick)

    t = threading.Thread(target=ticker, daemon=True)
    t.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


def cmd_worker(args):
    import urllib.request

    from davinci_tpu_torch.sequencer import DevStubProvers
    from davinci_tpu_torch.workers import WorkerClient, worker_uuid

    def transport(method, path, body):
        req = urllib.request.Request(
            args.master + path,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
            method=method,
        )
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    wid = worker_uuid(args.seed, args.name)
    worker = WorkerClient(wid, transport, DevStubProvers())
    print(f"worker {wid} polling {args.master}")
    while True:
        if not worker.tick():
            time.sleep(args.tick)


def cmd_e2e(args):
    """Synthetic election: create process, cast votes, settle, finalize
    (reference cmd/e2e-test/main.go role, in-process)."""
    from davinci_tpu_torch import spec
    from davinci_tpu_torch.elgamal import Ballot, generate_key
    from davinci_tpu_torch.sequencer import InMemoryChain, Sequencer
    from davinci_tpu_torch.sequencer.pipeline import ProcessInfo
    from davinci_tpu_torch.storage import MemoryKV, Storage

    r = random.Random(args.seed)
    pub, priv = generate_key(r)
    pid = 1
    info = ProcessInfo(
        process_id=pid,
        census_origin=1,
        ballot_mode=0,
        encryption_key=(pub.x, pub.y),
        state_root=spec.state_root(pid, 1, pub.x, pub.y, 0),
    )
    if getattr(args, "rpc_chain", False):
        # full HTTP JSON-RPC rim: contract bindings against the local
        # fake node (reference web3/ against a live endpoint)
        from davinci_tpu_torch.web3.contracts import ProcessRegistry, RpcChain
        from davinci_tpu_torch.web3.fakenode import FakeEthNode
        from davinci_tpu_torch.web3.rpc import JsonRpcClient

        node = FakeEthNode()
        server = node.serve()
        rpc = JsonRpcClient(
            f"http://127.0.0.1:{server.server_address[1]}/"
        )
        chain = RpcChain(
            ProcessRegistry(rpc, FakeEthNode.REGISTRY_ADDR, 0xD0D0CAFE)
        )
    else:
        chain = InMemoryChain()
    chain.create_process(info)
    seq = Sequencer(Storage(MemoryKV()), chain, batch_time_window=0.0)
    seq.register_process(info, priv_key=priv)

    t0 = time.time()
    for i in range(args.votes):
        choice = [0] * spec.FIELDS_PER_BALLOT
        choice[i % 2] = 1
        b = Ballot.encrypt(choice, pub, r.randrange(1, 2**200))
        seq.submit_ballot(
            pid, r.randrange(2**160), b, spec.VOTE_ID_MIN + r.randrange(2**40)
        )
    while seq.storage.pending_ballots.size() or seq.storage.verified_ballots.size():
        seq.tick_ballot(max_items=64)
        seq.tick_aggregate()
        seq.tick_transition(rng=r)
        seq.tick_onchain()
    chain.end_process(pid)
    seq.tick_finalizer(rng=r, prove_real=args.prove_results)
    res = chain.process(pid).results
    print(
        json.dumps(
            {
                "votes": args.votes,
                "results": res,
                "results_proven": args.prove_results,
                "transitions": len(chain.transitions),
                "seconds": round(time.time() - t0, 2),
            }
        )
    )
    assert res[0] + res[1] == args.votes


def cmd_circuit_compile(args):
    """Offline circuit compilation: run trusted setup through the artifact
    store (hash-pinned PK/VK files) and export Solidity verifiers for the
    on-chain BN254 circuits (reference cmd/circuit-compile/main.go:36-523,
    exportSolidityVerifierFile:386)."""
    import pathlib

    from davinci_tpu_torch.circuits.artifacts import ArtifactStore, default_store
    from davinci_tpu_torch.groth16 import Groth16
    from davinci_tpu_torch.groth16.serialize import vk_from_bytes
    from davinci_tpu_torch.web3.solidity_export import export_solidity_verifier

    store = ArtifactStore(args.artifacts_dir) if args.artifacts_dir else default_store()
    out_dir = pathlib.Path(args.out or store.root)
    out_dir.mkdir(parents=True, exist_ok=True)
    compiled = []

    if not args.export_only:
        # circuit 5 (results verifier): the one circuit compilable without
        # recursion-chain material; circuits 2-4 artifacts are produced by
        # the sequencer's ProtocolProvers on first use (same store)
        from davinci_tpu_torch.circuits.results import (
            build_results_circuit,
            results_witness_from_state,
        )
        from davinci_tpu_torch import spec
        from davinci_tpu_torch.elgamal import generate_key
        from davinci_tpu_torch.state.state import State

        r = random.Random(1)
        pub, priv = generate_key(r)

        st = State(1)
        st.initialize(1, 0, (pub.x, pub.y))
        w = results_witness_from_state(st, priv, 1 << 20, r)
        cs = build_results_circuit(
            w, n_levels=args.levels, n_fields=args.fields
        )
        cid = (
            "results-v1"
            if args.levels == spec.STATE_TREE_MAX_LEVELS
            else f"results-l{args.levels}f{args.fields}-v1"
        )
        rt = store.load_or_setup(cid, "bn254", cs)
        compiled.append((cid, rt.structure_hash))

    # export .sol for every bn254 artifact present
    exported = []
    for d in sorted(store.root.iterdir()) if store.root.exists() else []:
        meta_p, vk_p = d / "meta.json", d / "vk.bin"
        if not (meta_p.exists() and vk_p.exists()):
            continue
        meta = json.loads(meta_p.read_text())
        if meta.get("curve") != "bn254":
            continue
        g16 = Groth16("bn254")
        vk = vk_from_bytes(vk_p.read_bytes(), g16.g1, g16.g2)
        src = export_solidity_verifier(vk, name=meta["circuit_id"])
        sol_name = f"{meta['circuit_id']}.{meta['structure_hash'][:16]}.sol"
        (out_dir / sol_name).write_text(src)
        exported.append(sol_name)
    print(json.dumps({"compiled": compiled, "exported": exported}))


def cmd_send_blob(args):
    """Build N random blobs, compute KZG sidecar material, sign an
    EIP-4844 type-3 transaction and submit it over JSON-RPC (reference
    cmd/send-blob/main.go — pointed at a local fake RPC in this
    zero-egress environment; the tx bytes are real)."""
    from davinci_tpu_torch.blobs.kzg import Blob, blob_to_commitment
    from davinci_tpu_torch.ethereum import address_from_pubkey, pubkey_from_priv
    from davinci_tpu_torch.web3.blobtx import (
        SIDECAR_VERSION_0,
        SIDECAR_VERSION_1,
        build_blob_tx,
        sign_blob_tx,
    )
    from davinci_tpu_torch.web3.rpc import JsonRpcClient

    rng = random.Random(args.seed)
    priv = int(args.privkey, 16)
    sender = address_from_pubkey(pubkey_from_priv(priv))
    rpc = JsonRpcClient(args.rpc)
    chain_id = int(rpc.call("eth_chainId", []), 16)
    nonce = int(
        rpc.call("eth_getTransactionCount", [f"0x{sender.hex()}", "pending"]),
        16,
    )
    to = bytes.fromhex(args.to[2:]) if args.to else sender

    blobs_with_kzg = []
    for _ in range(args.n):
        cells = [rng.randrange(1 << 248) for _ in range(4096)]
        blob = Blob(cells)
        commitment = blob_to_commitment(blob)
        if args.cells:
            from davinci_tpu_torch.blobs.cells import compute_cell_proofs_device

            proofs = compute_cell_proofs_device(blob)
        else:
            from davinci_tpu_torch.blobs.kzg import compute_kzg_proof

            z = 2
            proof, _y = compute_kzg_proof(blob, z)
            proofs = proof
        blobs_with_kzg.append((blob.to_bytes(), commitment, proofs))

    tx = build_blob_tx(
        chain_id=chain_id, nonce=nonce, to=to, data=b"",
        blobs_with_kzg=blobs_with_kzg,
        sidecar_version=(
            SIDECAR_VERSION_1 if args.cells else SIDECAR_VERSION_0
        ),
    )
    tx = sign_blob_tx(tx, priv)
    raw = tx.encode_network()
    txh = rpc.call("eth_sendRawTransaction", ["0x" + raw.hex()])
    out = {"txHash": txh, "blobs": args.n, "from": "0x" + sender.hex()}
    if args.wait:
        for _ in range(60):
            rcpt = rpc.call("eth_getTransactionReceipt", [txh])
            if rcpt:
                out["status"] = rcpt.get("status")
                break
            time.sleep(2)
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(prog="davinci-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("sequencer", help="run the sequencer node")
    s.add_argument("--db", default="", help="sqlite path (default: memory)")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--batch-window", type=float, default=300.0)
    s.add_argument("--tick", type=float, default=1.0)
    s.add_argument("--worker-seed", default="", help="enable worker API")
    s.set_defaults(fn=cmd_sequencer)

    w = sub.add_parser("worker", help="run a proving worker")
    w.add_argument("--master", required=True)
    w.add_argument("--seed", required=True)
    w.add_argument("--name", default="worker")
    w.add_argument("--tick", type=float, default=1.0)
    w.set_defaults(fn=cmd_worker)

    e = sub.add_parser("e2e", help="run a synthetic election end-to-end")
    e.add_argument("--votes", type=int, default=4)
    e.add_argument("--seed", type=int, default=1)
    e.add_argument(
        "--prove-results", action="store_true",
        help="run the real Groth16 results-verifier prover at finalize "
        "(artifact-cached setup; reference RUN_CIRCUIT_TESTS role)",
    )
    e.add_argument(
        "--rpc-chain", action="store_true",
        help="run over the contract bindings + local fake JSON-RPC node "
        "instead of InMemoryChain",
    )
    e.set_defaults(fn=cmd_e2e)

    cc = sub.add_parser(
        "circuit-compile",
        help="offline artifact setup + Solidity verifier export",
    )
    cc.add_argument("--artifacts-dir", default="", help="artifact store root")
    cc.add_argument("--out", default="", help=".sol output dir (default: store)")
    cc.add_argument(
        "--export-only", action="store_true",
        help="only export .sol for existing bn254 artifacts",
    )
    cc.add_argument("--levels", type=int, default=64)
    cc.add_argument("--fields", type=int, default=8)
    cc.set_defaults(fn=cmd_circuit_compile)

    sb = sub.add_parser(
        "send-blob",
        help="build + sign + submit an EIP-4844 blob tx over JSON-RPC",
    )
    sb.add_argument("--rpc", required=True, help="JSON-RPC endpoint URL")
    sb.add_argument("--privkey", required=True, help="hex private key")
    sb.add_argument("--to", default="", help="destination (default sender)")
    sb.add_argument("-n", type=int, default=1, help="number of blobs")
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument(
        "--cells", action="store_true",
        help="EIP-7594 128-cell sidecar (version 1) instead of one proof",
    )
    sb.add_argument("--wait", action="store_true", help="poll for receipt")
    sb.set_defaults(fn=cmd_send_blob)

    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
