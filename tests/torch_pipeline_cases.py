"""Shared elections of the sequencer pipeline tests: one seeded election
driven through the `Sequencer` of one package, and the values the
reference's run of it gave.

`stub_election(pkg)` runs, with package `pkg` ("davinci_tpu" or
"davinci_tpu_torch") alone, the flow of the reference's
tests/test_pipeline.py with `DevStubProvers`: a first batch of three
ballots in four slots (fewer ballots than `votes_per_batch`; the window
of 0 s fires it), a second of four in which one address votes again,
the chain's settlement and the finalizer's decryption; then a second
process whose transition the chain refuses once (`fail_next`): the
local state rolls back and the retried submission settles.

`prover_election(pkg, store_dir)` runs the flow of the reference's
CPU prover tier (tests/test_pipeline_real_provers.py: the vote verifier
(c2) lite, proved through an `ArtifactStore` under `store_dir`; the
aggregator (c3, two slots) and the state transition (c4, two votes)
built and solved) on the toy 2-chain of the reference's
tests/test_pipeline_prove_tier.py: c2 on the toy BLS12 curve of 139-bit
p, c3 on its outer curve, which verifies c2's proofs natively as BW6-761
verifies BLS12-377's.  (The port proves on the CPU with its plain
PyTorch MSM: a c2 lite prove on BLS12-377 takes it minutes, on the toy
curve about 25 s.)  Its one batch is one ballot in the two slots: c3
pads it with the canonical dummy vote, c4 with an empty slot.

Each returns a record of plain values (ints, strings, lists): the vote
hashes and flags of the provers' outputs, the batch hash, c4's public
values, the roots after each batch, the vote statuses after each tick,
the chain's transitions, the sha256 of each blob and of its
`parse_blob_data`, the results and the storage's counters.  The port's
record must equal the reference's (`STUB_REFERENCE`,
`PROVER_REFERENCE`); `python tests/torch_pipeline_cases.py` (from the
root, with JAX) prints the reference's records again.
"""

import hashlib
import importlib
import json
import random

SEED = 0x5E9
PROCESS_ID = 9
ROLLBACK_PROCESS_ID = 10
# the finalizer's discrete-log bound: a result is at most the votes cast
# (the default, 10^12, is minutes of host search a process)
MAX_DL_BOUND = 1 << 8
STUB_SLOTS = 4
PROVER_SLOTS = 2


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def sha(data):
    return hashlib.sha256(data if isinstance(data, bytes)
                          else json.dumps(data, sort_keys=True).encode()
                          ).hexdigest()


class Election:
    """One process on one `Sequencer` of package `pkg`, and the record of
    what the ticks did."""

    def __init__(self, pkg, rng, provers=None, slots=STUB_SLOTS):
        self.pkg = pkg
        spec = self.spec = _mod(pkg, "spec")
        pipeline = _mod(pkg, "sequencer.pipeline")
        storage = _mod(pkg, "storage")
        self.elgamal = _mod(pkg, "elgamal")
        self.rng = rng
        self.chain = pipeline.InMemoryChain()
        self.seq = pipeline.Sequencer(
            storage.Storage(storage.MemoryKV()), self.chain,
            provers=provers, batch_time_window=0.0,
            max_dl_bound=MAX_DL_BOUND, votes_per_batch=slots)
        self.vote_ids = []
        self.vote_proofs = []  # the provers' outputs, proofs included
        self.record = {"statuses": [], "roots": [], "transitions": [],
                       "blobs": [], "parsed": [], "vote_proofs": [],
                       "aggregates": [], "state_transitions": []}

    def open(self, pid):
        pipeline = _mod(self.pkg, "sequencer.pipeline")
        pub, priv = self.elgamal.generate_key(self.rng)
        info = pipeline.ProcessInfo(
            process_id=pid, census_origin=1, ballot_mode=0,
            encryption_key=(pub.x, pub.y),
            state_root=self.spec.state_root(pid, 1, pub.x, pub.y, 0))
        self.chain.create_process(info)
        self.seq.register_process(info, priv_key=priv)
        return pub

    def vote(self, pid, pub, choice, address=None, client=None):
        b = self.elgamal.Ballot.encrypt(choice, pub,
                                        self.rng.randrange(1, 2**200))
        address = self.rng.randrange(2**160) if address is None else address
        vid = self.spec.VOTE_ID_MIN + self.rng.randrange(2**40)
        self.seq.submit_ballot(pid, address, b, vid,
                               client=client and client(self.rng))
        self.vote_ids.append((pid, vid))
        return address

    def statuses(self, tick):
        self.record["statuses"].append(
            [tick] + [int(self.seq.storage.vote_status(pid, vid))
                      for pid, vid in self.vote_ids])

    def batch(self, pid):
        """tick_ballot, tick_aggregate, tick_transition and tick_onchain,
        the statuses after each, what the provers made and the root."""
        seq = self.seq
        seq.tick_ballot()
        self.statuses("ballot")
        for _, item in seq.storage.verified_ballots.next(8):
            self.vote_proofs.append(item["vote_proof"])
            self.record["vote_proofs"].append(
                {k: v for k, v in item["vote_proof"].items() if k != "proof"})
        seq.storage.verified_ballots.release_all()
        seq.tick_aggregate()
        self.statuses("aggregate")
        for s, agg in seq.storage.agg_batches.next(1):
            self.record["aggregates"].append(
                {k: v for k, v in agg["proof"].items() if k != "proof"})
            seq.storage.agg_batches.release(s)
        seq.tick_transition(rng=self.rng)
        self.statuses("transition")
        for s, tr in seq.storage.transition_batches.next(1):
            self.record["state_transitions"].append(
                {k: v for k, v in tr["proof"].items() if k != "proof"})
            seq.storage.transition_batches.release(s)
        seq.tick_onchain()
        self.statuses("onchain")
        self.record["roots"].append(hex(seq.states[pid].root))

    def close(self, pid):
        parse = _mod(self.pkg, "state.blobcodec").parse_blob_data
        self.chain.end_process(pid)
        self.seq.tick_finalizer(rng=self.rng)
        self.record["results"] = self.chain.process(pid).results
        self.record["stats"] = self.seq.storage.stats(pid)
        self.record["chain_root"] = hex(self.chain.process(pid).state_root)
        for p, before, after, proof in self.chain.transitions:
            self.record["transitions"].append(
                [p, hex(before), hex(after), sha(proof)])
        for p, blob, sidecar in self.chain.blobs:
            parsed = parse(bytes.fromhex(blob))
            self.record["blobs"].append([p, sha(blob.encode()), sidecar])
            self.record["parsed"].append(
                [parsed["voters_count"],
                 [v["vote_id"] for v in parsed["votes"]], sha(parsed)])
        self.record["vote_ids"] = [vid for _, vid in self.vote_ids]
        return self.record


def stub_election(pkg):
    """The `DevStubProvers` election of package `pkg`: its record."""
    e = Election(pkg, random.Random(SEED))
    pub = e.open(PROCESS_ID)
    addresses = [e.vote(PROCESS_ID, pub, [1, 0, i % 2, 0, 0, 0, 0, 1])
                 for i in range(3)]
    e.batch(PROCESS_ID)  # three ballots in four slots
    e.vote(PROCESS_ID, pub, [0, 2, 0, 0, 0, 0, 0, 1], address=addresses[1])
    for i in range(3):
        e.vote(PROCESS_ID, pub, [1, 1, 0, 0, 0, 0, i, 1])
    e.batch(PROCESS_ID)  # four ballots, one overwriting
    pub2 = e.open(ROLLBACK_PROCESS_ID)
    e.vote(ROLLBACK_PROCESS_ID, pub2, [3, 0, 0, 0, 0, 0, 0, 0])
    seq = e.seq
    seq.tick_ballot()
    seq.tick_aggregate()
    seq.tick_transition(rng=e.rng)
    e.chain.fail_next = True
    seq.tick_onchain()  # refused: the state rolls back, the item is kept
    e.statuses("refused")
    rollback = {"local_root": hex(seq.states[ROLLBACK_PROCESS_ID].root),
                "chain_root": hex(
                    e.chain.process(ROLLBACK_PROCESS_ID).state_root),
                "pending_transitions": seq.storage.transition_batches.size()}
    seq.tick_onchain()  # the retry settles the same transition
    e.statuses("retried")
    rollback.update(
        retried_local_root=hex(seq.states[ROLLBACK_PROCESS_ID].root),
        retried_chain_root=hex(
            e.chain.process(ROLLBACK_PROCESS_ID).state_root),
        retried_pending=seq.storage.transition_batches.size())
    record = e.close(PROCESS_ID)
    record["rollback"] = rollback
    return record


# the toy 2-chain's adicity (toycurve.toy_2chain) and the batch hash's
# truncation, which must embed in its outer Fr (test_pipeline_prove_tier.py)
CHAIN_M = 13
HASH_BYTES = 16


def toy_provers(pkg, store_dir, g16_kw=None):
    """`ProtocolProvers` of package `pkg` on the toy 2-chain: c2 lite
    (no inner proof, no signature, the vote hash native) proved, c3 and
    c4 solved; `g16_kw` goes to the c2 backend's constructor (the port's
    `device`).  Returns (the provers, the toy inner curve's r)."""
    provers_mod = _mod(pkg, "sequencer.provers")
    t = _mod(pkg, "circuits.toycurve").toy_2chain(CHAIN_M)
    inner = t["inner"]
    params = _mod(pkg, "circuits.voteverifier").VoteVerifierParams(
        inner_ctx=inner["ctx"], inner_vk=None, sig_spec=inner["g1"],
        native_r=inner["r"], include_inner_proof=False,
        include_signature=False, hash_native=True)
    g16 = _mod(pkg, "groth16").Groth16(inner["ctx"].name, ctx=inner["ctx"],
                                        fr=inner["fr_spec"], **(g16_kw or {}))
    provers = provers_mod.ProtocolProvers(
        params, store=_mod(pkg, "circuits.artifacts").ArtifactStore(store_dir),
        modes=provers_mod.ProverModes(vote="prove", aggregate="solve",
                                      state_transition="solve"),
        n_votes_agg=PROVER_SLOTS,
        curves={"c2": inner["ctx"].name, "c3": t["ctx6"].name},
        g16s={inner["ctx"].name: g16},
        agg_overrides={"native_r": t["ctx6"].r, "inner_ctx": inner["ctx"],
                       "hash_bytes": HASH_BYTES},
        c4_overrides={"hash_bytes": HASH_BYTES})
    return provers, inner["r"]


def prover_election(pkg, store_dir, g16_kw=None):
    """The `ProtocolProvers` election of package `pkg` (c2 proved, c3 and
    c4 solved), its artifacts under `store_dir`.  Returns (its record,
    the `Election`)."""
    provers, inner_r = toy_provers(pkg, store_dir, g16_kw)
    e = Election(pkg, random.Random(SEED + 1), provers, slots=PROVER_SLOTS)
    pub = e.open(PROCESS_ID)
    fields = e.spec.FIELDS_PER_BALLOT
    e.vote(PROCESS_ID, pub, [int(j == 2) for j in range(fields)],
           client=lambda rng: {"inputs_hash": hex(rng.randrange(1, inner_r))})
    e.batch(PROCESS_ID)  # one ballot in two slots
    return e.close(PROCESS_ID), e


# The records of the reference's runs (`python tests/torch_pipeline_cases.py`)
STUB_REFERENCE = {
    'statuses': [['ballot', 1, 1, 1], ['aggregate', 2, 2, 2],
                 ['transition', 3, 3, 3], ['onchain', 4, 4, 4],
                 ['ballot', 4, 4, 4, 1, 1, 1, 1],
                 ['aggregate', 4, 4, 4, 2, 2, 2, 2],
                 ['transition', 4, 4, 4, 3, 3, 3, 3],
                 ['onchain', 4, 4, 4, 4, 4, 4, 4],
                 ['refused', 4, 4, 4, 4, 4, 4, 4, 3],
                 ['retried', 4, 4, 4, 4, 4, 4, 4, 4]],
    'roots': ['0x1d8db9a7de5b09b800e8a61a90266ba07ee8395fa1e4025b26fbc6b4e0886996',
              '0x1183e9565a2b5df8b4ab8eb02d441e5ef33db7f921cb454372483aac8693de48'],
    'transitions': [[9,
                     '0x18b8b4fbaecabcd6e007709c255967e6667599b876a3ee07673ce6e9e63dfa05',
                     '0x1d8db9a7de5b09b800e8a61a90266ba07ee8395fa1e4025b26fbc6b4e0886996',
                     '57b5461b99a6a33a58d70bfdf66c039f66e99567e0aa4a237148f01db5806af3'],
                    [9,
                     '0x1d8db9a7de5b09b800e8a61a90266ba07ee8395fa1e4025b26fbc6b4e0886996',
                     '0x1183e9565a2b5df8b4ab8eb02d441e5ef33db7f921cb454372483aac8693de48',
                     '57b5461b99a6a33a58d70bfdf66c039f66e99567e0aa4a237148f01db5806af3'],
                    [10,
                     '0x2726f83b106ae26befcb5ad0b149327849d6b68a67458c5bab4ec393f7b04bf2',
                     '0x19cd9e31ac45d32f17e68fc840c29bbd09e9c848eb639fd72093b05eeaa3f596',
                     '57b5461b99a6a33a58d70bfdf66c039f66e99567e0aa4a237148f01db5806af3']],
    'blobs': [[9,
               '1227057ad7478acd5b8e1ef484053c943e7821c8b5999ffa720bc1ee3bfe26a2',
               None],
              [9,
               '12d047b5185b03812cd64d2fa23d781dfcdc8a0f6651864efdc0c344cdbea49b',
               None],
              [10,
               '4327de7ffe6d39d971a66e596f3f7ea15f8e2c29d029a5cd6630063915738356',
               None]],
    'parsed': [[3,
                [9223372607832256086, 9223372455059885650,
                 9223373104985478479],
                '16973c09540bf06b11191372216e6dcf58ab5b3ea32903a1cc27d2732366460b'],
               [4,
                [9223372594350896499, 9223372430081932565, 9223373032523289449,
                 9223372767181023907],
                '7a15b529fea4734b4909ea0564d4df030cc2bdc0b29f74db6536ba743bddeb63'],
               [1, [9223372695576951061],
                '139465e42b1f344d779efe7eafd9e31066d4366b10db5cb4ca149dcfcd22b062']],
    'vote_proofs': [{'kind': 'vote', 'proven': False},
                    {'kind': 'vote', 'proven': False},
                    {'kind': 'vote', 'proven': False},
                    {'kind': 'vote', 'proven': False},
                    {'kind': 'vote', 'proven': False},
                    {'kind': 'vote', 'proven': False},
                    {'kind': 'vote', 'proven': False}],
    'aggregates': [{'kind': 'aggregate', 'count': 3, 'proven': False},
                   {'kind': 'aggregate', 'count': 4, 'proven': False}],
    'state_transitions': [{'kind': 'state_transition', 'proven': False},
                          {'kind': 'state_transition', 'proven': False}],
    'results': [5, 5, 0, 0, 0, 0, 3, 6],
    'stats': {'aggregated_votes': 7,
              'settled_transitions': 2,
              'state_transitions': 2,
              'verified_votes': 7},
    'chain_root': '0x1183e9565a2b5df8b4ab8eb02d441e5ef33db7f921cb454372483aac8693de48',
    'vote_ids': [9223372607832256086, 9223372455059885650, 9223373104985478479,
                 9223372594350896499, 9223372430081932565, 9223373032523289449,
                 9223372767181023907, 9223372695576951061],
    'rollback': {'local_root': '0x2726f83b106ae26befcb5ad0b149327849d6b68a67458c5bab4ec393f7b04bf2',
                 'chain_root': '0x2726f83b106ae26befcb5ad0b149327849d6b68a67458c5bab4ec393f7b04bf2',
                 'pending_transitions': 1,
                 'retried_local_root': '0x2726f83b106ae26befcb5ad0b149327849d6b68a67458c5bab4ec393f7b04bf2',
                 'retried_chain_root': '0x19cd9e31ac45d32f17e68fc840c29bbd09e9c848eb639fd72093b05eeaa3f596',
                 'retried_pending': 0},
}
PROVER_REFERENCE = {
    'statuses': [['ballot', 1], ['aggregate', 2], ['transition', 3],
                 ['onchain', 4]],
    'roots': ['0x309649e5bbe28f9beea7621f95b61833b3d7776ecfc07d9ea70d255a0d058a6'],
    'transitions': [[9,
                     '0x2c976fd29cea02749593d475236964613ae703e7a6c33108bdaf64850bf8e2ea',
                     '0x309649e5bbe28f9beea7621f95b61833b3d7776ecfc07d9ea70d255a0d058a6',
                     '1a619374decc2d21bbe77f63ac1c3e4486e70f9c376e34ee5b645a5d31e96b3d']],
    'blobs': [[9,
               'd2f8da07c937f346dd4ad3bbc89b36718d457d380e2bb5e81730af6b7b34d770',
               None]],
    'parsed': [[1, [9223373014794215365],
                '00d1a41b7b28b0e718f7278f6b37ea0b30906a6e3b4a9a497c542040c4191d0c']],
    'vote_proofs': [{'kind': 'vote',
                     'proven': True,
                     'vote_hash': '0x1bf1262cc8be41b37fdbcb62'}],
    'aggregates': [{'kind': 'aggregate',
                    'count': 1,
                    'proven': False,
                    'solved': True,
                    'batch_hash': '0xe1c81c74c46b896cc1774cab8bb21546',
                    'vote_hashes': ['0x1bf1262cc8be41b37fdbcb62']}],
    'state_transitions': [{'kind': 'state_transition',
                           'proven': False,
                           'solved': True,
                           'public': ['0x2c976fd29cea02749593d475236964613ae703e7a6c33108bdaf64850bf8e2ea',
                                      '0x309649e5bbe28f9beea7621f95b61833b3d7776ecfc07d9ea70d255a0d058a6',
                                      '0xe18ff2663e43035373a96a3302e525c7']}],
    'results': [0, 0, 1, 0, 0, 0, 0, 0],
    'stats': {'aggregated_votes': 1,
              'settled_transitions': 1,
              'state_transitions': 1,
              'verified_votes': 1},
    'chain_root': '0x309649e5bbe28f9beea7621f95b61833b3d7776ecfc07d9ea70d255a0d058a6',
    'vote_ids': [9223373014794215365],
}


def normalized(record):
    """The record as JSON gives it back (tuples as lists)."""
    return json.loads(json.dumps(record))


# The checks, collected by the files that import them with the module
# fixtures `stub`, (package, record), and `prover`, (package, record,
# `Election`).


def test_stub_election_equals_the_recorded_run(stub):
    _, record = stub
    assert normalized(record) == STUB_REFERENCE


def test_stub_election_settles_and_tallies(stub):
    _, record = stub
    settled = int(_mod(stub[0], "storage").VoteIDStatus.SETTLED)
    assert record["statuses"][-1][1:] == [settled] * 8
    # three ballots in four slots: the window fired the batch
    assert [p[0] for p in record["parsed"]] == [3, 4, 1]
    assert record["aggregates"][0]["count"] == 3
    # the tally of the choices, the second voter's first ballot replaced
    assert record["results"] == [5, 5, 0, 0, 0, 0, 3, 6]
    assert record["chain_root"] == record["roots"][-1]
    assert record["stats"] == {"aggregated_votes": 7,
                               "settled_transitions": 2,
                               "state_transitions": 2,
                               "verified_votes": 7}


def test_stub_refused_transition_rolls_back(stub):
    _, record = stub
    rb = record["rollback"]
    _, before, after, _ = record["transitions"][-1]
    # refused: the state is back at the chain's root, the item kept
    assert rb["local_root"] == rb["chain_root"] == before
    assert rb["pending_transitions"] == 1
    # retried: the chain settles the batch; the local state stays rolled
    # back (`tick_onchain` re-applies nothing), as in the reference
    assert rb["retried_chain_root"] == after
    assert rb["retried_local_root"] == before
    assert rb["retried_pending"] == 0


def test_prover_election_equals_the_recorded_run(prover):
    _, record, _ = prover
    assert normalized(record) == PROVER_REFERENCE


def test_prover_vote_proof_verifies_and_pads_c3(prover):
    _, record, e = prover
    [vp] = e.vote_proofs
    provers = e.seq.provers
    assert vp["proven"] and provers.verify_vote(vp)
    assert not provers.verify_vote(
        {**vp, "vote_hash": hex(int(vp["vote_hash"], 16) + 1)})
    [agg] = record["aggregates"]
    # one ballot in two slots: c3 solved with the dummy vote in the other
    assert agg["solved"] and agg["count"] == 1
    assert agg["vote_hashes"] == [vp["vote_hash"]]
    assert provers._dummy[1] != int(vp["vote_hash"], 16)


def test_prover_c4_solves_one_ballot_in_two_slots(prover):
    _, record, e = prover
    [tr] = record["state_transitions"]
    assert tr["solved"] and e.seq.votes_per_batch == PROVER_SLOTS == 2
    assert record["parsed"][0][0] == 1
    assert tr["public"][:2] == record["transitions"][0][1:3]
    assert record["results"] == [0, 0, 1, 0, 0, 0, 0, 0]


if __name__ == "__main__":
    import sys
    import tempfile

    sys.path.insert(0, ".")
    import jax

    jax.config.update("jax_platforms", "cpu")
    print("STUB_REFERENCE =", json.dumps(stub_election("davinci_tpu"),
                                        indent=1))
    with tempfile.TemporaryDirectory() as d:
        print("PROVER_REFERENCE =",
              json.dumps(prover_election("davinci_tpu", d)[0], indent=1))
