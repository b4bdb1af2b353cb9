"""The sequencer's EIP-7594 sidecar in davinci_tpu_torch: with
DAVINCI_CELL_PROOFS set, `tick_transition` imports
`blobs.cells.compute_cell_proofs_device` and attaches a version-1
sidecar of 128 cell proofs, which the chain checks and keeps.

One ballot goes through each package's `Sequencer` (stub provers, the
in-memory chain) with the commitment and the 128 proofs made by one host
stand-in in both (the card's proofs are held to the host path in
`chip_smoke.py`'s phase 14; on the CPU the 128 4,096-point MSMs take
hours): the blob and the sidecar the chain keeps must be equal.
Tolerance: exact equality of bytes and hex strings.
"""

import importlib
import random

import torch

REF, PORT = "davinci_tpu", "davinci_tpu_torch"

torch.set_num_threads(1)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _sidecar_election(pkg, monkeypatch):
    kzg, cells = _mod(pkg, "blobs.kzg"), _mod(pkg, "blobs.cells")
    g1 = _mod(pkg, "curves").bls381_g1
    monkeypatch.setattr(kzg, "blob_to_commitment", lambda blob: kzg.compress_g1(
        g1.gen.mul(sum(blob.cells) % kzg.R)))
    monkeypatch.setattr(cells, "compute_cell_proofs_device", lambda blob: [
        kzg.compress_g1(g1.gen.mul(i + 1)) for i in range(cells.CELLS_PER_BLOB)])
    spec = _mod(pkg, "spec")
    pipeline = _mod(pkg, "sequencer.pipeline")
    storage = _mod(pkg, "storage")
    elgamal = _mod(pkg, "elgamal")
    r = random.Random(7594)
    pub, priv = elgamal.generate_key(r)
    pid = 5
    info = pipeline.ProcessInfo(
        process_id=pid, census_origin=1, ballot_mode=0,
        encryption_key=(pub.x, pub.y),
        state_root=spec.state_root(pid, 1, pub.x, pub.y, 0))
    chain = pipeline.InMemoryChain()
    chain.create_process(info)
    seq = pipeline.Sequencer(storage.Storage(storage.MemoryKV()), chain,
                             batch_time_window=0.0, max_dl_bound=1 << 4)
    seq.register_process(info, priv_key=priv)
    ballot = elgamal.Ballot.encrypt([1] + [0] * 7, pub, r.randrange(1, 2**200))
    seq.submit_ballot(pid, r.randrange(2**160), ballot,
                      spec.VOTE_ID_MIN + r.randrange(2**40))
    seq.tick_ballot()
    seq.tick_aggregate()
    seq.tick_transition(rng=r)
    seq.tick_onchain()
    [(got_pid, blob, sidecar)] = chain.blobs
    return got_pid, blob, sidecar


def test_transition_attaches_the_cell_sidecar(monkeypatch):
    monkeypatch.setenv("DAVINCI_CELL_PROOFS", "1")
    got = _sidecar_election(PORT, monkeypatch)
    assert got == _sidecar_election(REF, monkeypatch)
    _, _, sidecar = got
    assert sidecar["version"] == 1 and len(sidecar["cell_proofs"]) == 128


def test_without_the_flag_no_sidecar(monkeypatch):
    monkeypatch.delenv("DAVINCI_CELL_PROOFS", raising=False)
    assert _sidecar_election(PORT, monkeypatch)[2] is None
