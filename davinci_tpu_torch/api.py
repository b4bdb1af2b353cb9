"""HTTP API: REST surface for votes, processes, censuses, stats, workers.

Role parity: reference api/ (routes.go:11-63 route table, vote.go:185+
newVote validation flow, workers.go master endpoints, info.go).  Built on
the stdlib http.server (the image carries no web framework); handlers are
plain methods over the sequencer/census/storage objects, so they are unit-
testable without sockets and servable with ThreadingHTTPServer.

Vote intake (POST /votes) validates: payload shape, vote-ID recomputation,
EIP-191 signature recovery to the claimed address, census membership
(Merkle or CSP), then queues the pending ballot — mirroring
api/vote.go:185+ (the circom ballot-proof re-verification slot is wired but
lands with the ballotproof circuit)."""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from davinci_tpu_torch import spec
from davinci_tpu_torch.census import CensusDB
from davinci_tpu_torch.csp import BabyJubJubEdDSA
from davinci_tpu_torch.sequencer.pipeline import Sequencer, ballot_from_wire
from davinci_tpu_torch.storage import VoteIDStatus
from davinci_tpu_torch import ethereum as eth


class ApiError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


class API:
    """Route table + handlers; transport-agnostic."""

    def __init__(
        self, sequencer: Sequencer, census_db: CensusDB, jobs_manager=None,
        ballot_verifier=None,
    ):
        """ballot_verifier: optional (g16, vk) pair for circuit 1 — when
        set, every incoming vote's ballot proof is natively verified at
        intake (one pairing check per vote; reference
        api/ballotproof_verifier.go:13-58)."""
        self.seq = sequencer
        self.census = census_db
        self.jobs = jobs_manager
        self.ballot_verifier = ballot_verifier
        self.routes = [
            ("GET", re.compile(r"^/workers/([\w-]+)/job$"), self.worker_get_job),
            ("POST", re.compile(r"^/workers/([\w-]+)/job/([\w:-]+)$"), self.worker_submit_job),
            ("GET", re.compile(r"^/sequencer/workers$"), self.worker_stats),
            ("POST", re.compile(r"^/votes$"), self.post_vote),
            ("GET", re.compile(r"^/votes/(\d+)/process/(\d+)/status$"), self.vote_status),
            ("GET", re.compile(r"^/processes$"), self.list_processes),
            ("GET", re.compile(r"^/processes/(\d+)$"), self.get_process),
            ("POST", re.compile(r"^/censuses$"), self.new_census),
            ("POST", re.compile(r"^/censuses/([\w-]+)/participants$"), self.add_participants),
            ("GET", re.compile(r"^/censuses/([\w-]+)/root$"), self.census_root),
            ("GET", re.compile(r"^/censuses/([\w-]+)/size$"), self.census_size),
            ("POST", re.compile(r"^/censuses/([\w-]+)/publish$"), self.publish_census),
            ("GET", re.compile(r"^/censuses/(\d+)/proof/(\d+)$"), self.census_proof),
            ("GET", re.compile(r"^/sequencer/stats/(\d+)$"), self.stats),
            ("GET", re.compile(r"^/info$"), self.info),
            ("GET", re.compile(r"^/hostLoad$"), self.host_load),
            ("GET", re.compile(r"^/app/?$"), self.webapp),
        ]

    def dispatch(self, method: str, path: str, body: dict | None) -> dict:
        for m, rx, fn in self.routes:
            if m != method:
                continue
            match = rx.match(path)
            if match:
                return fn(*match.groups(), body=body)
        raise ApiError(404, f"no route for {method} {path}")

    # -- votes ---------------------------------------------------------------

    def post_vote(self, body: dict):
        """reference api/vote.go newVote: shape checks, signature, census
        membership, then PushPendingBallot."""
        try:
            pid = int(body["processID"])
            address = int(body["address"], 16) if isinstance(body["address"], str) else int(body["address"])
            vote_id = int(body["voteID"])
            ballot_coords = [int(x) for x in body["ballot"]]
            weight = int(body.get("weight", 1))
            sig = body["signature"]
        except (KeyError, ValueError, TypeError) as e:
            raise ApiError(400, f"malformed vote: {e}")

        if pid not in self.seq.states:
            raise ApiError(404, "unknown process")
        if len(ballot_coords) != spec.FIELDS_PER_BALLOT * 4:
            raise ApiError(400, "bad ballot shape")
        if not (spec.VOTE_ID_MIN <= vote_id <= spec.VOTE_ID_MAX):
            raise ApiError(400, "vote ID out of range")
        if self.seq.storage.vote_status(pid, vote_id) is not None:
            raise ApiError(409, "vote ID already submitted")

        # EIP-191 signature over the vote ID binds the voter address
        payload = vote_id.to_bytes(8, "big").rjust(32, b"\x00")
        rec_addr = eth.recover_address(
            payload, int(sig["r"]), int(sig["s"]), int(sig["rec"])
        )
        if rec_addr is None or int.from_bytes(rec_addr, "big") != address:
            raise ApiError(401, "signature does not match address")
        # recovered public key: circuit 2's ECDSA witness material
        prefixed = eth.keccak256(
            b"\x19Ethereum Signed Message:\n32" + payload
        )
        pub_pt = eth.recover(prefixed, int(sig["r"]), int(sig["s"]), int(sig["rec"]))

        # census membership
        cproof = body.get("censusProof")
        if cproof is None:
            raise ApiError(400, "census proof required")
        census_proof = self._check_census(pid, address, cproof)

        # ballot-proof verification at intake (reference
        # api/ballotproof_verifier.go:26 — one pairing check per vote)
        client = {
            "sig_r": hex(int(sig["r"])),
            "sig_s": hex(int(sig["s"])),
        }
        if pub_pt is not None and not pub_pt.infinity:
            client["pubkey"] = [hex(pub_pt.x.v), hex(pub_pt.y.v)]
        bp = body.get("ballotProof")
        if self.ballot_verifier is not None:
            if bp is None:
                raise ApiError(400, "ballot proof required")
            from davinci_tpu_torch.groth16.serialize import proof_from_dict

            g16, vk = self.ballot_verifier
            try:
                proof = proof_from_dict(bp["proof"], g16.g1, g16.g2)
                ih = int(bp["inputsHash"], 16)
            except (KeyError, ValueError, TypeError) as e:
                raise ApiError(400, f"malformed ballot proof: {e}")
            if not g16.verify(vk, proof, [ih]):
                raise ApiError(401, "ballot proof invalid")
            client["inputs_hash"] = hex(ih)
            client["ballot_proof"] = bp["proof"]
        elif bp is not None:
            client["inputs_hash"] = bp.get("inputsHash", "0x0")
            client["ballot_proof"] = bp.get("proof")

        ballot = ballot_from_wire(ballot_coords)
        self.seq.submit_ballot(
            pid, address, ballot, vote_id, weight, client=client,
            census_proof=census_proof,
        )
        return {"status": "pending", "voteID": vote_id}

    def _check_census(self, pid: int, address: int, cproof: dict) -> dict:
        """Validate and return the normalized census proof (it rides the
        ballot into circuit 4's census witness)."""
        kind = cproof.get("kind")
        info = getattr(self.seq, "chain", None)
        info = info.processes.get(pid) if info is not None else None
        expected_root = getattr(info, "census_root", 0) if info else 0
        if kind == "merkle":
            proof = dict(cproof["proof"])
            proof["kind"] = "merkle"
            proof["siblings"] = [int(s) for s in proof["siblings"]]
            proof["root"] = int(proof["root"])
            proof["leaf"] = int(proof["leaf"])
            proof["address"] = int(proof["address"])
            proof["weight"] = int(proof["weight"])
            proof["index"] = int(proof.get("index", 0))
            proof["size"] = int(proof.get("size", 0))
            proof["path_bits"] = [int(b) for b in proof["path_bits"]]
            if proof["address"] != address or not CensusDB.verify_proof(proof):
                raise ApiError(401, "census proof invalid")
            if expected_root and proof["root"] != expected_root:
                raise ApiError(401, "census root mismatch")
            return proof
        elif kind == "csp":
            from davinci_tpu_torch.csp import EdDSASignature

            p = dict(cproof["proof"])
            p["public_key"] = tuple(int(v) for v in p["public_key"])
            p["root"] = int(p["root"])
            p["address"] = int(p["address"])
            p["process_id"] = int(p["process_id"])
            p["weight"] = int(p["weight"])
            p["voter_index"] = int(p.get("voter_index", 0))
            s = p["signature"]
            p["signature"] = EdDSASignature(
                (int(s["r8x"]), int(s["r8y"])), int(s["s"])
            )
            if p["address"] != address or not BabyJubJubEdDSA.verify_proof(p):
                raise ApiError(401, "csp proof invalid")
            if expected_root and p["root"] != expected_root:
                raise ApiError(401, "census root mismatch")
            # JSON-safe form (the ballot queues serialize items as JSON)
            sig = p["signature"]
            return {
                "kind": "csp",
                "root": p["root"],
                "address": p["address"],
                "process_id": p["process_id"],
                "weight": p["weight"],
                "voter_index": p["voter_index"],
                "public_key": list(p["public_key"]),
                "signature": {
                    "r8x": sig.r8[0], "r8y": sig.r8[1], "s": sig.s,
                },
            }
        else:
            raise ApiError(400, f"unknown census proof kind {kind}")

    def vote_status(self, vote_id: str, pid: str, body=None):
        st = self.seq.storage.vote_status(int(pid), int(vote_id))
        if st is None:
            raise ApiError(404, "unknown vote")
        return {"status": VoteIDStatus(st).name.lower()}

    # -- processes -----------------------------------------------------------

    def list_processes(self, body=None):
        return {"processes": sorted(self.seq.states.keys())}

    def get_process(self, pid: str, body=None):
        pid = int(pid)
        if pid not in self.seq.states:
            raise ApiError(404, "unknown process")
        info = self.seq.chain.processes.get(pid)
        st = self.seq.states[pid]
        return {
            "processID": pid,
            "stateRoot": str(st.root),
            "chainRoot": str(info.state_root) if info else None,
            "ended": bool(info.ended) if info else False,
            "results": [str(x) for x in info.results] if info and info.results else None,
        }

    # -- censuses ------------------------------------------------------------

    def new_census(self, body=None):
        ref = self.census.new()
        return {"censusID": ref.census_id}

    def add_participants(self, cid: str, body: dict):
        if cid not in self.census.by_id:
            raise ApiError(404, "unknown census")
        for p in body.get("participants", []):
            self.census.insert(cid, int(p["address"]), int(p.get("weight", 1)))
        return {"size": self.census.by_id[cid].tree.size}

    def census_root(self, cid: str, body=None):
        return {"root": str(self.census.by_id[cid].tree.root)}

    def census_size(self, cid: str, body=None):
        return {"size": self.census.by_id[cid].tree.size}

    def publish_census(self, cid: str, body=None):
        return {"root": str(self.census.publish(cid))}

    def census_proof(self, root: str, address: str, body=None):
        try:
            p = self.census.proof_by_root(int(root), int(address))
        except KeyError:
            raise ApiError(404, "unknown root or address")
        return {
            "proof": {
                **{k: str(v) for k, v in p.items() if k not in ("siblings", "path_bits")},
                "siblings": [str(s) for s in p["siblings"]],
                "path_bits": p["path_bits"],
            }
        }

    # -- workers (reference api/workers.go:230-288) --------------------------

    def worker_get_job(self, wid: str, body=None):
        if self.jobs is None:
            raise ApiError(404, "worker API disabled")
        job = self.jobs.get_job(wid)
        if job is None:
            return {}
        return job

    def worker_submit_job(self, wid: str, job_id: str, body: dict):
        if self.jobs is None:
            raise ApiError(404, "worker API disabled")
        ok = self.jobs.submit_job(wid, job_id, body or {})
        return {"accepted": bool(ok)}

    def worker_stats(self, body=None):
        if self.jobs is None:
            raise ApiError(404, "worker API disabled")
        return {"workers": self.jobs.wm.snapshot()}

    # -- info / stats --------------------------------------------------------

    def stats(self, pid: str, body=None):
        return self.seq.storage.stats(int(pid))

    def info(self, body=None):
        return {
            "name": "davinci-tpu",
            "processes": len(self.seq.states),
            "queues": {
                q: getattr(self.seq.storage, q).size()
                for q in self.seq.storage.QUEUES
            },
        }

    def host_load(self, body=None):
        """System metrics (reference api/info.go:35-68 hostLoad): 1-min
        load average, memory/disk used percentages, process RSS."""
        import shutil

        out = {"hostLoad1": 0.0, "hostMemUsedPercent": 0.0,
               "hostDiskUsedPercent": {}, "memStats": {}}
        try:
            out["hostLoad1"] = os.getloadavg()[0]
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as f:
                mem = {
                    k.rstrip(":"): int(v.split()[0])
                    for k, v, *_ in (
                        line.split(None, 2) for line in f if line.strip()
                    )
                }
            total = mem.get("MemTotal", 0)
            avail = mem.get("MemAvailable", 0)
            if total:
                out["hostMemUsedPercent"] = round(
                    100.0 * (total - avail) / total, 2
                )
        except (OSError, ValueError):
            pass
        try:
            du = shutil.disk_usage("/")
            out["hostDiskUsedPercent"]["/"] = round(
                100.0 * du.used / du.total, 2
            )
        except OSError:
            pass
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        out["memStats"]["rssKiB"] = int(line.split()[1])
                        break
        except (OSError, ValueError):
            pass
        return out

    def webapp(self, body=None):
        """Static dashboard (reference api/api.go:29-32 webapp role)."""
        from davinci_tpu_torch.webapp import DASHBOARD_HTML

        return {"__html__": DASHBOARD_HTML}


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------


def serve(api: API, host: str = "127.0.0.1", port: int = 0):
    """Start a ThreadingHTTPServer; returns (server, thread)."""

    class Handler(BaseHTTPRequestHandler):
        def _respond(self, code: int, payload: dict):
            if isinstance(payload, dict) and "__html__" in payload:
                data = payload["__html__"].encode()
                ctype = "text/html; charset=utf-8"
            else:
                data = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # request logging (reference api/middleware.go:78-154
        # loggingMiddleware): method/path/status/duration + truncated JSON
        # body at debug level; health-check-style endpoints excluded
        LOG_EXCLUDED = ("/app", "/hostLoad", "/info")
        MAX_BODY_LOG = 512

        def _handle(self, method):
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
            body = None
            if raw:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    return self._respond(400, {"error": "bad json"})
            t0 = time.monotonic()
            status = 200
            try:
                out = api.dispatch(method, self.path, body)
                self._respond(200, out)
            except ApiError as e:
                status = e.code
                self._respond(e.code, {"error": e.msg})
            except Exception as e:  # pragma: no cover
                status = 500
                self._respond(500, {"error": str(e)})
            if not any(self.path.startswith(p) for p in self.LOG_EXCLUDED):
                from davinci_tpu_torch import log

                kv = {
                    "method": method,
                    "path": self.path,
                    "status": status,
                    "took_ms": round(1e3 * (time.monotonic() - t0), 2),
                }
                if raw[:1] in (b"{", b"["):
                    body_str = raw.decode("utf-8", "replace")
                    if len(body_str) > self.MAX_BODY_LOG:
                        body_str = body_str[: self.MAX_BODY_LOG] + "..."
                    kv["body"] = body_str
                log.debugw("api.request", **kv)

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread
