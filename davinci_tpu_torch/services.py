"""Service daemons: process monitor, census importers, state-sync wiring.

Role parity: reference service/ — `ProcessMonitor` (process_monitor.go:
44-459: polls chain events, registers new processes, reacts to status/
census/state-root changes), `CensusDownloader` (census_service.go:91-438:
async census fetch with retries + working->published lifecycle), and the
census importer plugins (census/importer.go:19-49: JSON snapshot, GraphQL,
on-chain dynamic).

The chain boundary here is the InMemoryChain fake (no egress in this
environment); importers consume file/dict snapshots and callback sources,
matching the reference's plugin seam so a real transport drops in.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

from davinci_tpu_torch import log
from davinci_tpu_torch.census import CensusDB


# ---------------------------------------------------------------------------
# Census importers (reference census/importer.go)
# ---------------------------------------------------------------------------


class JSONSnapshotImporter:
    """Import a static census from a JSON snapshot:
    {"participants": [{"address": "0x..", "weight": 1}, ...]}
    (reference census/json.go)."""

    def __init__(self, censusdb: CensusDB):
        self.db = censusdb

    def import_snapshot(self, data: str | dict, census_id: str | None = None):
        if isinstance(data, str):
            data = json.loads(data)
        ref = self.db.new(census_id)
        n = 0
        for p in data["participants"]:
            addr = p["address"]
            if isinstance(addr, str):
                addr = int(addr, 16)
            self.db.insert(ref.census_id, addr, int(p.get("weight", 1)))
            n += 1
        log.infow("census.import.json", census=ref.census_id, participants=n)
        return ref

    def import_file(self, path: str, census_id: str | None = None):
        with open(path) as f:
            return self.import_snapshot(f.read(), census_id)

    # dispatcher plugin interface (CensusImporter)
    @staticmethod
    def valid_uri(uri: str) -> bool:
        return isinstance(uri, str) and (
            uri.startswith("file://") or uri.endswith(".json")
        )

    def import_census(self, census: dict, processed: int = 0):
        uri = census["uri"]
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        ref = self.import_file(path)
        root = self.db.publish(ref.census_id)
        want = census.get("root")
        if want is not None and root != want:
            raise ValueError(
                f"census root mismatch: built {root:#x}, expected {want:#x}"
            )
        return ref, ref.tree.size


GRAPHQL_WEIGHT_QUERY = """\
query GetWeightChangeEvents($first: Int!, $skip: Int!) {
  weightChangeEvents(
    first: $first
    skip: $skip
    orderBy: blockNumber
    orderDirection: asc
  ) {
    account { id }
    previousWeight
    newWeight
  }
}"""


class GraphQLImporter:
    """GraphQL census importer (reference census/graphql.go): pages
    `weightChangeEvents` from a subgraph endpoint, folds them into final
    per-account weights (last newWeight wins; zero removes), and builds
    the census.  Speaks plain HTTP JSON — tested against a local stub
    server (this environment has no egress)."""

    def __init__(self, censusdb: CensusDB, endpoint: str,
                 page_size: int = 1000, timeout: float = 30.0,
                 query: str = GRAPHQL_WEIGHT_QUERY):
        self.db = censusdb
        self.endpoint = endpoint
        self.page_size = page_size
        self.timeout = timeout
        self.query = query

    def _fetch_page(self, skip: int) -> list:
        import urllib.request

        payload = json.dumps({
            "query": self.query,
            "variables": {"first": self.page_size, "skip": skip},
        }).encode()
        req = urllib.request.Request(
            self.endpoint, data=payload,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if out.get("errors"):
            raise RuntimeError(
                f"graphql: {out['errors'][0].get('message', 'error')}"
            )
        return out["data"]["weightChangeEvents"]

    def fetch_weights(self) -> dict:
        """All pages -> {address(int): weight(int)} final state."""
        weights: dict = {}
        skip = 0
        while True:
            events = self._fetch_page(skip)
            if not events:
                break
            for ev in events:
                addr = int(ev["account"]["id"], 16)
                w = int(ev["newWeight"])
                if w == 0:
                    weights.pop(addr, None)
                else:
                    weights[addr] = w
            if len(events) < self.page_size:
                break
            skip += len(events)
        return weights

    def import_all(self, census_id: str | None = None):
        weights = self.fetch_weights()
        ref = self.db.new(census_id)
        for addr in sorted(weights):
            self.db.insert(ref.census_id, addr, weights[addr])
        log.infow(
            "census.import.graphql", census=ref.census_id,
            participants=len(weights), endpoint=self.endpoint,
        )
        return ref


class CallbackImporter:
    """Dynamic importer: pulls (address, weight) batches from a source
    callable until exhausted — the seam the reference's GraphQL
    (census3-bigquery) and on-chain importers plug into
    (census/graphql.go, census/importer.go:19-49)."""

    def __init__(self, censusdb: CensusDB, source, batch_size: int = 512):
        self.db = censusdb
        self.source = source  # source(offset, limit) -> list[(addr, weight)]
        self.batch_size = batch_size

    def import_all(self, census_id: str | None = None):
        ref = self.db.new(census_id)
        off = 0
        while True:
            batch = self.source(off, self.batch_size)
            if not batch:
                break
            for addr, weight in batch:
                self.db.insert(ref.census_id, addr, weight)
            off += len(batch)
        log.infow("census.import.dynamic", census=ref.census_id, total=off)
        return ref


class OnchainDynamicImporter:
    """On-chain dynamic census importer (the third reference plugin:
    census/importer.go:19-49 + censusdb.ImportByScopedAddress): the census
    lives under a CHAIN-SCOPED identity (chainID, contract address)
    instead of by-root — a dynamic census's root evolves as on-chain
    weight changes land — and imports are INCREMENTAL, resuming from the
    already-processed element count the caller tracks (importer.go
    `processedElements`).  Each import publishes a frozen by-root
    snapshot (proofs stay valid for that root) while the scoped working
    tree keeps evolving.

    The chain transport is a source callable
    `source(contract, offset, limit) -> [(address, weight), ...]`
    (weight 0 = removal->zero-weight update), fed by web3/ contract event
    readers in production and by fakes in tests (zero-egress seam)."""

    def __init__(self, censusdb: CensusDB, chain_id: int, source,
                 batch_size: int = 512):
        self.db = censusdb
        self.chain_id = chain_id
        self.source = source
        self.batch_size = batch_size

    @staticmethod
    def valid_uri(uri: str) -> bool:
        return isinstance(uri, str) and uri.startswith("onchain://")

    def scoped_id(self, contract: int) -> str:
        return f"onchain-{self.chain_id}-{contract:#042x}"

    def import_census(self, census: dict, processed: int = 0):
        """census: {"uri": "onchain://0x<contract>", "root": int|None}.
        Returns (ref, processed') — processed' is the cursor for the next
        incremental import."""
        uri = census["uri"]
        assert self.valid_uri(uri), f"not an on-chain census uri: {uri}"
        contract = int(uri[len("onchain://"):], 16)
        cid = self.scoped_id(contract)
        ref = self.db.by_id.get(cid) or self.db.new(cid)
        off = processed
        while True:
            batch = self.source(contract, off, self.batch_size)
            if not batch:
                break
            for addr, weight in batch:
                if addr in ref.index_by_address:
                    self.db.update_weight(cid, addr, weight)
                else:
                    self.db.insert(cid, addr, weight)
            off += len(batch)
        root = ref.tree.root
        want = census.get("root")
        if want is not None and root != want:
            raise ValueError(
                f"onchain census root mismatch: built {root:#x}, "
                f"expected {want:#x}"
            )
        # frozen by-root snapshot: proofs for THIS root survive further
        # dynamic updates to the scoped working tree
        import copy as _copy

        snap = _copy.deepcopy(ref)
        snap.published = True
        self.db.by_root[root] = snap
        log.infow(
            "census.import.onchain", census=cid, chain_id=self.chain_id,
            contract=f"{contract:#x}", processed=off, root=f"{root:#x}",
        )
        return ref, off


class CensusImporter:
    """Plugin dispatcher (reference census/importer.go CensusImporter):
    routes a census descriptor to the first plugin whose valid_uri
    accepts it; by-root dedupe; CSP origins need no download."""

    def __init__(self, censusdb: CensusDB, plugins):
        self.db = censusdb
        self.plugins = list(plugins)

    def import_census(self, census: dict, processed: int = 0):
        from davinci_tpu_torch import spec as protocol

        origin = census.get("origin", protocol.CENSUS_ORIGIN_MERKLE_STATIC)
        if origin == protocol.CENSUS_ORIGIN_CSP_EDDSA_BJJ:
            return None, processed  # CSP censuses are not downloaded
        assert origin in protocol.MERKLE_CENSUS_ORIGINS, (
            f"unsupported census origin: {origin}"
        )
        root = census.get("root")
        if root is not None and root in self.db.by_root:
            log.infow("census.import.skip", root=f"{root:#x}")
            return self.db.by_root[root], processed
        for plugin in self.plugins:
            if plugin.valid_uri(census.get("uri", "")):
                return plugin.import_census(census, processed)
        raise LookupError(
            f"no importer plugin for census uri: {census.get('uri')!r}"
        )


# ---------------------------------------------------------------------------
# Process monitor (reference service/process_monitor.go)
# ---------------------------------------------------------------------------


@dataclass
class MonitorStats:
    new_processes: int = 0
    ended_processes: int = 0
    root_updates: int = 0


class ProcessMonitor:
    """Polls the chain for process lifecycle changes and drives the
    sequencer: registers newly created processes, flags ended ones for the
    finalizer, and surfaces state-root divergence (the state-sync trigger).
    """

    def __init__(self, chain, sequencer, interval: float = 1.0):
        self.chain = chain
        self.seq = sequencer
        self.interval = interval
        self.stats = MonitorStats()
        self._known: dict[int, dict] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # one scan — deterministic for tests (reference monitor loop body)
    def tick(self):
        for pid, info in list(self.chain.processes.items()):
            prev = self._known.get(pid)
            if prev is None:
                self._known[pid] = {
                    "ended": info.ended,
                    "root": info.state_root,
                }
                if pid not in self.seq.states:
                    try:
                        self.seq.register_process(info)
                        self.stats.new_processes += 1
                        log.infow("monitor.new_process", pid=pid)
                    except AssertionError:
                        # root mismatch: a foreign-state process — needs
                        # state sync before we can serve it
                        log.warnw("monitor.root_mismatch", pid=pid)
                continue
            if info.ended and not prev["ended"]:
                prev["ended"] = True
                self.stats.ended_processes += 1
                log.infow("monitor.process_ended", pid=pid)
            if info.state_root != prev["root"]:
                prev["root"] = info.state_root
                self.stats.root_updates += 1

    def start(self):
        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception as e:  # monitor must not die
                    log.errorw("monitor.tick_error", error=str(e))
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
