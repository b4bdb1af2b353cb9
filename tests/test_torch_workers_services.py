"""The proving farm (`workers.py`), the service daemons (`services.py`) and
the node's configuration (`config.py`) of davinci_tpu_torch, verbatim
copies, held against the JAX package's on the CPU.

The cases of tests/test_workers.py and tests/test_services.py run once
with each package on the same seeded inputs, and `Config.from_env` on
the same environment; each gives a record of plain values (vote
statuses, worker counters, bans, census roots, proofs and sizes, monitor
counters, the GraphQL pages asked for, config fields), which must be
equal in both.  Tolerance: exact equality of ints, strings and JSON.
"""

import dataclasses
import http.server
import importlib
import json
import random
import threading
import time
import uuid
from types import SimpleNamespace

import pytest

REF, PORT = "davinci_tpu", "davinci_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _counted_uuids(pkg, monkeypatch):
    counter = iter(range(1, 1 << 20))
    monkeypatch.setattr(_mod(pkg, "census"), "_uuid", SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=next(counter))))


# -- workers (tests/test_workers.py) -------------------------------------------


def _farm(pkg, ban_seconds=0.2):
    """test_workers.py's fixture in package `pkg`."""
    spec = _mod(pkg, "spec")
    pipeline = _mod(pkg, "sequencer.pipeline")
    storage = _mod(pkg, "storage")
    workers = _mod(pkg, "workers")
    r = random.Random(66)
    pub, priv = _mod(pkg, "elgamal").generate_key(r)
    pid = 4
    info = pipeline.ProcessInfo(
        process_id=pid, census_origin=1, ballot_mode=0,
        encryption_key=(pub.x, pub.y),
        state_root=spec.state_root(pid, 1, pub.x, pub.y, 0))
    chain = pipeline.InMemoryChain()
    chain.create_process(info)
    seq = pipeline.Sequencer(storage.Storage(storage.MemoryKV()), chain)
    seq.register_process(info, priv_key=priv)
    wm = workers.WorkerManager("master-seed", ban_seconds=ban_seconds)
    jm = workers.JobsManager(seq.storage, wm)
    api = _mod(pkg, "api").API(seq, _mod(pkg, "census").CensusDB(),
                               jobs_manager=jm)

    def submit(n):
        vids = []
        for _ in range(n):
            b = _mod(pkg, "elgamal").Ballot.encrypt([1] * 8, pub,
                                                    r.randrange(1, 2**200))
            vid = spec.VOTE_ID_MIN + r.randrange(2**40)
            seq.submit_ballot(pid, r.randrange(2**160), b, vid)
            vids.append(vid)
        return vids

    transport = lambda m, p, b: api.dispatch(m, p, b)
    return SimpleNamespace(pkg=pkg, seq=seq, wm=wm, jm=jm, api=api, pid=pid,
                           submit=submit, transport=transport,
                           workers=workers,
                           stub=_mod(pkg, "sequencer").DevStubProvers)


def _worker_processes_jobs(pkg):
    f = _farm(pkg)
    vids = f.submit(3)
    wid = f.workers.worker_uuid("master-seed", "worker-1")
    worker = f.workers.WorkerClient(wid, f.transport, f.stub())
    ticks = 0
    while worker.tick():
        ticks += 1
    statuses = [int(f.seq.storage.vote_status(f.pid, v)) for v in vids]
    snap = f.api.dispatch("GET", "/sequencer/workers", None)["workers"]
    verified = [(it["vote_id"], it["vote_proof"])
                for _, it in f.seq.storage.verified_ballots.next(8)]
    return {"wid": wid, "ticks": ticks, "statuses": statuses,
            "snapshot": snap, "verified": verified,
            "stats": f.seq.storage.stats(f.pid)}


def _failing_worker_gets_banned(pkg):
    f = _farm(pkg)
    f.submit(5)

    class FailingProvers:
        def prove_vote(self, _):
            raise RuntimeError("boom")

    wid = f.workers.worker_uuid("master-seed", "bad-worker")
    worker = f.workers.WorkerClient(wid, f.transport, FailingProvers())
    for _ in range(3):
        worker.tick()
    out = {"allowed": f.wm.allowed(wid), "job": f.jm.get_job(wid),
           "snapshot": f.wm.snapshot()}
    time.sleep(0.25)  # the ban of 0.2 s runs out
    out["allowed_after"] = f.wm.allowed(wid)
    out["released"] = f.seq.storage.pending_ballots.release_stale()
    good = f.workers.WorkerClient(
        f.workers.worker_uuid("master-seed", "good"), f.transport, f.stub())
    n = 0
    while good.tick():
        n += 1
    out["good"] = n
    return out


NOW = int(time.time())  # one clock for both packages' tokens


def _auth_tokens(pkg):
    w = _mod(pkg, "workers")
    seed, soon, past = "s3cret", NOW + 600, NOW - 1
    tok = w.auth_token(seed, "w1", soon)
    expired = w.auth_token(seed, "w1", past)
    return {"tokens": [tok, expired],
            "checks": [w.check_auth_token(seed, "w1", tok),
                       w.check_auth_token(seed, "w2", tok),
                       w.check_auth_token("other", "w1", tok),
                       w.check_auth_token(seed, "w1", expired),
                       w.check_auth_token(seed, "w1", "garbage")],
            "uuid": w.worker_uuid("master-seed", "worker-1")}


# -- services (tests/test_services.py) -----------------------------------------


def _process_monitor(pkg):
    spec = _mod(pkg, "spec")
    pipeline = _mod(pkg, "sequencer.pipeline")
    storage = _mod(pkg, "storage")
    pub, _ = _mod(pkg, "elgamal").generate_key(random.Random(3))
    chain = pipeline.InMemoryChain()
    seq = pipeline.Sequencer(storage.Storage(storage.MemoryKV()), chain)
    mon = _mod(pkg, "services").ProcessMonitor(chain, seq)
    seen = []

    def tick():
        mon.tick()
        seen.append(dataclasses.astuple(mon.stats))

    tick()
    pid = 9
    chain.create_process(pipeline.ProcessInfo(
        process_id=pid, census_origin=1, ballot_mode=0,
        encryption_key=(pub.x, pub.y),
        state_root=spec.state_root(pid, 1, pub.x, pub.y, 0)))
    tick()
    registered = pid in seq.states
    chain.end_process(pid)
    tick()
    chain.processes[pid].state_root = 12345
    tick()
    return {"stats": seen, "registered": registered}


def _json_snapshot(pkg):
    census = _mod(pkg, "census")
    db = census.CensusDB()
    imp = _mod(pkg, "services").JSONSnapshotImporter(db)
    snap = {"participants": [{"address": "0xabc123", "weight": 2},
                             {"address": "0xdef456"},
                             {"address": 777, "weight": 5}]}
    ref = imp.import_snapshot(json.dumps(snap))
    root = db.publish(ref.census_id)
    proof = db.proof_by_root(root, 0xABC123)
    return {"census_id": ref.census_id, "root": root, "proof": proof,
            "verified": census.CensusDB.verify_proof(proof)}


def _callback_paginates(pkg):
    db = _mod(pkg, "census").CensusDB()
    rows = [(1000 + i, 1) for i in range(25)]
    pages = []

    def source(offset, limit):
        pages.append((offset, limit))
        return rows[offset:offset + limit]

    ref = _mod(pkg, "services").CallbackImporter(db, source,
                                                 batch_size=10).import_all()
    tree = db.by_id[ref.census_id].tree
    return {"size": tree.size, "root": tree.root, "pages": pages}


GRAPHQL_EVENTS = (
    [{"account": {"id": hex(2000 + i)}, "previousWeight": "0",
      "newWeight": "1"} for i in range(13)]
    + [{"account": {"id": hex(2003)}, "previousWeight": "1",
        "newWeight": "9"}]       # update wins
    + [{"account": {"id": hex(2007)}, "previousWeight": "1",
        "newWeight": "0"}]       # removal
)


def _graphql(pkg):
    """test_services.py's GraphQL importer against a local stub subgraph:
    pagination, last-newWeight-wins folding, zero-weight removal."""
    seen_pages = []

    class Stub(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            first, skip = body["variables"]["first"], body["variables"]["skip"]
            seen_pages.append((first, skip))
            data = json.dumps({"data": {"weightChangeEvents":
                                        GRAPHQL_EVENTS[skip:skip + first]}})
            data = data.encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        db = _mod(pkg, "census").CensusDB()
        imp = _mod(pkg, "services").GraphQLImporter(
            db, f"http://127.0.0.1:{server.server_address[1]}/subgraph",
            page_size=6)
        ref = imp.import_all()
        tree = db.by_id[ref.census_id].tree
        root = db.publish(ref.census_id)
        return {"size": tree.size, "pages": seen_pages, "root": root,
                "proof": db.proof_by_root(root, 2003)}
    finally:
        server.shutdown()
        server.server_close()


def _onchain(pkg):
    """test_services.py's on-chain importer: chain-scoped identity, the
    incremental cursor, weight updates, per-root snapshots, root pinning."""
    census = _mod(pkg, "census")
    services = _mod(pkg, "services")
    contract = 0xDEADBEEF00000000000000000000000000000001
    events = [(0xA1, 1), (0xA2, 2), (0xA3, 1)]

    def source(c, offset, limit):
        assert c == contract
        return events[offset:offset + limit]

    db = census.CensusDB()
    imp = services.OnchainDynamicImporter(db, chain_id=11155111,
                                          source=source, batch_size=2)
    spec_ = {"uri": f"onchain://{contract:#x}"}
    ref, processed = imp.import_census(spec_, 0)
    root1 = ref.tree.root
    out = {"id": ref.census_id, "scoped": imp.scoped_id(contract),
           "processed": [processed], "roots": [root1]}
    events.extend([(0xA2, 7), (0xA4, 3)])
    ref, processed = imp.import_census(spec_, processed)
    root2 = ref.tree.root
    out["processed"].append(processed)
    out["roots"].append(root2)
    out["weights"] = [db.proof_by_root(root1, 0xA2)["weight"],
                      db.proof_by_root(root2, 0xA2)["weight"],
                      db.proof_by_root(root2, 0xA4)["weight"]]
    with pytest.raises(ValueError) as err:
        imp.import_census({"uri": spec_["uri"], "root": 1234}, processed)
    out["pinned"] = str(err.value)
    return out


def _dispatch(pkg, tmp_path):
    census = _mod(pkg, "census")
    services = _mod(pkg, "services")
    protocol = _mod(pkg, "spec")
    db = census.CensusDB()
    snap = {"participants": [{"address": "0xb1", "weight": 1},
                             {"address": "0xb2", "weight": 4}]}
    p = tmp_path / f"census-{pkg}.json"
    p.write_text(json.dumps(snap))
    onchain = services.OnchainDynamicImporter(
        db, chain_id=1, source=lambda c, o, l: [] if o else [(0xC1, 1)])
    disp = services.CensusImporter(db, [onchain,
                                        services.JSONSnapshotImporter(db)])
    ref, n = disp.import_census({"uri": str(p)})
    ref2, n2 = disp.import_census({"uri": "onchain://0xabc"})
    ref3, n3 = disp.import_census({"uri": str(p), "root": ref.tree.root})
    got, n4 = disp.import_census(
        {"origin": protocol.CENSUS_ORIGIN_CSP_EDDSA_BJJ}, 9)
    return {"n": [n, n2, n3, n4], "roots": [ref.tree.root, ref2.tree.root,
                                            ref3.tree.root],
            "ids": [ref.census_id, ref2.census_id], "csp": got,
            "cached": ref3 is ref}


CASES = {
    "worker_processes_jobs": _worker_processes_jobs,
    "failing_worker_gets_banned": _failing_worker_gets_banned,
    "auth_tokens": _auth_tokens,
    "process_monitor": _process_monitor,
    "json_snapshot": _json_snapshot,
    "callback_paginates": _callback_paginates,
    "graphql": _graphql,
    "onchain_dynamic": _onchain,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case, monkeypatch):
    runs = []
    for pkg in (PORT, REF):
        _counted_uuids(pkg, monkeypatch)
        runs.append(CASES[case](pkg))
    got, want = runs
    assert got == want
    if case == "worker_processes_jobs":
        assert got["statuses"] == [1] * 3  # VERIFIED
        assert got["snapshot"][got["wid"]]["success"] == 3
    if case == "failing_worker_gets_banned":
        assert (got["allowed"], got["job"], got["allowed_after"],
                got["good"]) == (False, None, True, 5)
    if case == "auth_tokens":
        assert got["checks"] == [True, False, False, False, False]
    if case == "process_monitor":
        assert got["registered"]
        assert got["stats"][-1] == (1, 1, 1)
    if case == "graphql":
        assert got["size"] == 12 and got["proof"]["weight"] == 9


def test_census_importer_dispatch_matches_reference(tmp_path, monkeypatch):
    runs = []
    for pkg in (PORT, REF):
        _counted_uuids(pkg, monkeypatch)
        runs.append(_dispatch(pkg, tmp_path))
    assert runs[0] == runs[1]
    assert runs[0]["n"] == [2, 1, 0, 9] and runs[0]["csp"] is None


def test_config_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("DAVINCI_API_PORT", "9999")
    monkeypatch.setenv("DAVINCI_FORCE_CLEANUP", "true")
    monkeypatch.setenv("DAVINCI_BATCH_TIME_WINDOW", "12.5")
    got, want = (dataclasses.asdict(_mod(pkg, "config").Config.from_env(
        worker_name="w7")) for pkg in (PORT, REF))
    assert got == want
    assert (got["api_port"], got["force_cleanup"], got["batch_time_window"],
            got["worker_name"], got["votes_per_batch"]) == (
        9999, True, 12.5, "w7", 60)
