"""The node's HTTP API of davinci_tpu_torch (`api.py`, a verbatim copy)
held against the JAX package's on the CPU.

Each case of tests/test_api.py runs once with each package on the same
seeded inputs (the census IDs, random in the node, drawn from a counter
in both): vote intake, a bad signature, a wrong census weight, a vote
under a CSP census signed by the package's own `BabyJubJubEdDSA`, and the
HTTP transport.  The responses (or the `ApiError` codes and messages)
and the storage's state after them (every key of the KV but the queue
reservations, which hold the clock) must be equal.  The last case
records a fault the two packages share: the API stores the voter's
recovered key as hex strings, which `ProtocolProvers.prove_vote` hands to
`spec.point`, which takes ints; both raise the same error at "solve".
Tolerance: exact equality of JSON values, bytes and messages.
"""

import importlib
import json
import random
import urllib.request
import uuid
from types import SimpleNamespace

import pytest

import torch

REF, PORT = "davinci_tpu", "davinci_tpu_torch"

torch.set_num_threads(1)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _env(pkg, monkeypatch):
    """test_api.py's fixture in package `pkg`: a process with its
    encryption key on an in-memory chain, its sequencer and API."""
    spec = _mod(pkg, "spec")
    census = _mod(pkg, "census")
    counter = iter(range(1, 1 << 20))
    monkeypatch.setattr(census, "_uuid", SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=next(counter))))
    r = random.Random(55)
    pub, priv = _mod(pkg, "elgamal").generate_key(r)
    pid = 3
    pipeline = _mod(pkg, "sequencer.pipeline")
    info = pipeline.ProcessInfo(
        process_id=pid, census_origin=1, ballot_mode=0,
        encryption_key=(pub.x, pub.y),
        state_root=spec.state_root(pid, 1, pub.x, pub.y, 0))
    chain = pipeline.InMemoryChain()
    chain.create_process(info)
    storage = _mod(pkg, "storage")
    kv = storage.MemoryKV()
    seq = pipeline.Sequencer(storage.Storage(kv), chain)
    seq.register_process(info, priv_key=priv)
    api_mod = _mod(pkg, "api")
    api = api_mod.API(seq, census.CensusDB())
    return SimpleNamespace(pkg=pkg, api=api, api_mod=api_mod, seq=seq,
                           pid=pid, pub=pub, r=r, kv=kv, spec=spec,
                           eth=_mod(pkg, "ethereum"))


def _vote_body(e, census_cid=None):
    """test_api.py's `_make_vote_body`."""
    eth, api, r = e.eth, e.api, e.r
    eth_priv = r.randrange(1, eth.N)
    address = int.from_bytes(
        eth.address_from_pubkey(eth.pubkey_from_priv(eth_priv)), "big")
    cid = census_cid or api.new_census(body=None)["censusID"]
    api.add_participants(cid, body={"participants": [
        {"address": address, "weight": 1}]})
    root = int(api.publish_census(cid, body=None)["root"])
    proof = api.census_proof(str(root), str(address), body=None)["proof"]
    vote_id = e.spec.VOTE_ID_MIN + r.randrange(2**40)
    payload = vote_id.to_bytes(8, "big").rjust(32, b"\x00")
    rr, ss, rec = eth.sign_eth_prefixed(eth_priv, payload)
    ballot = _mod(e.pkg, "elgamal").Ballot.encrypt(
        [1, 0, 0, 0, 0, 0, 0, 1], e.pub, r.randrange(1, 2**200))
    return {
        "processID": e.pid, "address": address, "voteID": vote_id,
        "weight": 1, "ballot": [str(c) for c in ballot.coords()],
        "signature": {"r": rr, "s": ss, "rec": rec},
        "censusProof": {"kind": "merkle", "proof": proof},
    }


def _call(e, method, path, body):
    try:
        return {"ok": e.api.dispatch(method, path, body)}
    except e.api_mod.ApiError as err:
        return {"code": err.code, "msg": err.msg}


def _state(e):
    """The KV but the queues' reservations (their values are times)."""
    return {k.hex(): v.decode() for k, v in sorted(e.kv._d.items())
            if not k.startswith(b"r/")}


def _intake(e):
    body = _vote_body(e)
    out = [_call(e, "POST", "/votes", body),
           _call(e, "GET", f"/votes/{body['voteID']}/process/{e.pid}/status",
                 None),
           _call(e, "POST", "/votes", body)]  # a duplicate
    return out


def _bad_signature(e):
    body = _vote_body(e)
    body["signature"]["s"] = int(body["signature"]["s"]) ^ 1
    return [_call(e, "POST", "/votes", body)]


def _wrong_census(e):
    body = _vote_body(e)
    body["censusProof"]["proof"]["weight"] = "99"
    return [_call(e, "POST", "/votes", body)]


def _csp(e):
    """test_api.py's CSP case: a fresh key signs the vote ID; the census
    proof is the package's own BabyJubJubEdDSA's."""
    eth, r = e.eth, e.r
    body = _vote_body(e)
    signer = _mod(e.pkg, "csp").BabyJubJubEdDSA(b"csp")
    body["voteID"] = e.spec.VOTE_ID_MIN + 999
    payload = body["voteID"].to_bytes(8, "big").rjust(32, b"\x00")
    eth_priv = r.randrange(1, eth.N)
    addr = int.from_bytes(
        eth.address_from_pubkey(eth.pubkey_from_priv(eth_priv)), "big")
    p = signer.generate_proof(e.pid, addr, 1)
    sig = p.pop("signature")
    p["signature"] = {"r8x": sig.r8[0], "r8y": sig.r8[1], "s": sig.s}
    rr, ss, rec = eth.sign_eth_prefixed(eth_priv, payload)
    body.update(address=addr, signature={"r": rr, "s": ss, "rec": rec},
                censusProof={"kind": "csp", "proof": p})
    return [_call(e, "POST", "/votes", body)]


def _http(e):
    """The same routes over a socket: /info, POST /votes, the dashboard,
    and /hostLoad (its keys: the values are the host's)."""
    server, _ = e.api_mod.serve(e.api)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/info") as resp:
            info = json.loads(resp.read())
        req = urllib.request.Request(
            base + "/votes", data=json.dumps(_vote_body(e)).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req) as resp:
            vote = json.loads(resp.read())
        with urllib.request.urlopen(base + "/app") as resp:
            page = (resp.headers["Content-Type"], resp.read().decode())
        with urllib.request.urlopen(base + "/hostLoad") as resp:
            load = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    assert load["hostMemUsedPercent"] > 0
    return [info, vote, page, sorted(load)]


CASES = {"intake": _intake, "bad_signature": _bad_signature,
         "wrong_census": _wrong_census, "csp_census": _csp, "http": _http}


def _run(pkg, case, monkeypatch):
    e = _env(pkg, monkeypatch)
    return CASES[case](e), _state(e)


@pytest.mark.parametrize("case", sorted(CASES))
def test_api_case_matches_reference(case, monkeypatch):
    got, got_state = _run(PORT, case, monkeypatch)
    want, want_state = _run(REF, case, monkeypatch)
    assert got == want
    assert got_state == want_state
    if case in ("intake", "csp_census"):
        assert got[0]["ok"]["status"] == "pending"
    if case == "intake":
        assert got[1] == {"ok": {"status": "pending"}}
        assert got[2]["code"] == 409
    if case in ("bad_signature", "wrong_census"):
        assert got[0]["code"] == 401
    if case == "http":
        assert got[0]["name"] == "davinci-tpu" and got[0]["processes"] == 1
        assert got[1]["status"] == "pending"
        assert got[2][0].startswith("text/html")
        assert "/sequencer/stats" in got[2][1]


def _prove_api_item(pkg, monkeypatch):
    """A vote taken in by the API, handed to `ProtocolProvers.prove_vote`
    at "solve" on the toy tier with the signature (the toy 2-chain's inner
    curve, no inner proof): the error it raises, as (type, message)."""
    e = _env(pkg, monkeypatch)
    _call(e, "POST", "/votes", _vote_body(e))
    [(_, item)] = e.seq.storage.pending_ballots.next(1)
    assert all(isinstance(v, str) for v in item["client"]["pubkey"])
    inner = _mod(pkg, "circuits.toycurve").toy_2chain(13)["inner"]
    params = _mod(pkg, "circuits.voteverifier").VoteVerifierParams(
        inner_ctx=inner["ctx"], inner_vk=None, sig_spec=inner["g1"],
        native_r=inner["r"], include_inner_proof=False,
        include_signature=True, hash_native=True)
    provers_mod = _mod(pkg, "sequencer.provers")
    provers = provers_mod.ProtocolProvers(
        params, store=object(), modes=provers_mod.ProverModes(
            vote="solve", aggregate="stub", state_transition="stub"))
    with pytest.raises(AttributeError) as err:
        provers.prove_vote(item)
    return type(err.value).__name__, str(err.value)


def test_api_pubkey_fails_prove_vote_alike(monkeypatch):
    """Queue C: `api.py` stores the recovered key as [hex(x), hex(y)];
    `provers.py` passes the strings to `spec.point`, which turns only
    ints into field elements.  Both packages fail alike."""
    got = _prove_api_item(PORT, monkeypatch)
    assert got == _prove_api_item(REF, monkeypatch)
    assert got == ("AttributeError", "'str' object has no attribute 'square'")
