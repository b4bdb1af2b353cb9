"""State sync (`statesync.py`, a verbatim copy) against the reference: the
seeded producer of the reference's tests/test_statesync.py runs two
batches through each package's `Sequencer` (`DevStubProvers`), and a
follower that starts from the process's genesis rebuilds the state from
the chain's blobs alone.  The port's blobs and roots are the
reference's, the port's follower reaches the producer's root and results,
and each package's `apply_blob` replays the other's blobs to the same
roots.
"""

import importlib
import random

import pytest
import torch

torch.set_num_threads(1)

SEED = 77
PID = 12


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def produce(pkg):
    """Two batches of two ballots through package `pkg`'s sequencer:
    (chain, producer, public key)."""
    spec = _mod(pkg, "spec")
    elgamal = _mod(pkg, "elgamal")
    pipeline = _mod(pkg, "sequencer.pipeline")
    storage = _mod(pkg, "storage")
    r = random.Random(SEED)
    pub, priv = elgamal.generate_key(r)
    info = pipeline.ProcessInfo(
        process_id=PID, census_origin=1, ballot_mode=0,
        encryption_key=(pub.x, pub.y),
        state_root=spec.state_root(PID, 1, pub.x, pub.y, 0))
    chain = pipeline.InMemoryChain()
    chain.create_process(info)
    producer = pipeline.Sequencer(storage.Storage(storage.MemoryKV()), chain,
                                  batch_time_window=0.0)
    producer.register_process(info, priv_key=priv)
    for _ in range(2):
        for _ in range(2):
            b = elgamal.Ballot.encrypt([1, 0, 0, 0, 0, 0, 0, 0], pub,
                                       r.randrange(1, 2**200))
            producer.submit_ballot(PID, r.randrange(2**160), b,
                                   spec.VOTE_ID_MIN + r.randrange(2**40))
        producer.tick_ballot()
        producer.tick_aggregate()
        producer.tick_transition(rng=r)
        producer.tick_onchain()
    return chain, producer, pub


def genesis(pkg, pub):
    st = _mod(pkg, "state").State(PID)
    st.initialize(1, 0, (pub.x, pub.y))
    return st


@pytest.fixture(scope="module")
def runs():
    return {pkg: produce(pkg) for pkg in ("davinci_tpu_torch", "davinci_tpu")}


def test_blobs_and_roots_equal_the_reference(runs):
    chain, producer, _ = runs["davinci_tpu_torch"]
    ref_chain, ref_producer, _ = runs["davinci_tpu"]
    assert len(chain.blobs) == 2
    assert chain.blobs == ref_chain.blobs
    assert [t[:3] for t in chain.transitions] == [
        t[:3] for t in ref_chain.transitions]
    assert producer.states[PID].root == ref_producer.states[PID].root


def test_follower_rebuilds_the_producers_state(runs):
    from davinci_tpu_torch.statesync import StateSync

    chain, producer, pub = runs["davinci_tpu_torch"]
    follower = genesis("davinci_tpu_torch", pub)
    sync = StateSync(chain, {PID: follower})
    sync.tick()
    assert follower.root == chain.process(PID).state_root
    assert follower.root == producer.states[PID].root
    assert (follower.results().coords()
            == producer.states[PID].results().coords())
    assert sync.applied == {PID: 2}
    sync.tick()  # nothing new on the chain: nothing applied again
    assert sync.applied == {PID: 2}
    assert follower.root == producer.states[PID].root


@pytest.mark.parametrize("blobs_of,replayer", [
    ("davinci_tpu", "davinci_tpu_torch"),
    ("davinci_tpu_torch", "davinci_tpu"),
])
def test_apply_blob_replays_the_other_packages_blobs(runs, blobs_of,
                                                      replayer):
    chain, _, _ = runs[blobs_of]
    _, other, pub = runs[replayer]
    apply_blob = _mod(replayer, "statesync").apply_blob
    st = genesis(replayer, pub)
    roots = [apply_blob(st, bytes.fromhex(blob)) for _, blob, _ in chain.blobs]
    assert roots == [t[2] for t in chain.transitions]
    assert roots[-1] == other.states[PID].root
