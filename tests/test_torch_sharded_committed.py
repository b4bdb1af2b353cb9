"""Committed proves of davinci_tpu_torch's Groth16 with a mesh set, held
against the reference's single-device proof, on the CPU.

A committed prove draws a blind wire before its commitment MSMs.  With a
mesh, every rank must commit to the same blind, or the ranks' sharded
MSMs would sum blocks of different witnesses.  The circuit is
`tests/torch_sharded_ranks.py`'s `blinded_range_circuit`: the lookup
range circuit of torch_committed_cases with its blind wire constrained,
so that the blind reaches D, pok and the A MSM.  With the reference's
key carried across by `convert.py`, two gloo groups of two ranks,
spawned at once (`run_committed`), prove it with r = 5 and s = 9: one
by `prove_committed`, one by `prove_committed_reuse` of a system built
once.  Rank d draws from random.Random(11 + d), so the ranks' own blinds
differ; every rank must return the reference's single-device
`prove_committed` with random.Random(11), rank 0's draw, which this
process computes meanwhile; rank 0 verifies it, rank 1 refuses it for
public + 1.
"""

import pickle
import random

import pytest
import torch.multiprocessing as mp

import torch_sharded_ranks as ranks

from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16.serialize import proof_to_dict as ref_proof_to_dict
from davinci_tpu_torch import convert
from davinci_tpu_torch.groth16 import Groth16

WORLD = 2
MODES = ("committed", "reuse")
JOIN_S = 240  # the spawns' deadline; each collective times out at 60 s


def _ref_build(challenge, blind):
    return ranks.blinded_range_circuit("davinci_tpu", challenge, blind)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mode: [rank results]}, the reference's proof and the port's
    proving key."""
    tmp = tmp_path_factory.mktemp("sharded_committed")
    ref = RefGroth16("bn254")
    rpk, rvk = ref.setup(_ref_build(0, 0))
    port = Groth16("bn254", device="cpu")
    pk = convert.proving_key_from_reference(rpk, port.g1, port.g2)
    key_path = tmp / "key.pkl"
    with open(key_path, "wb") as f:
        pickle.dump((pk, convert.verifying_key_from_reference(
            rvk, port.g1, port.g2)), f)
    ctxs = {}
    for mode in MODES:
        out = tmp / mode
        out.mkdir()
        ctxs[mode] = mp.spawn(ranks.run_committed, nprocs=WORLD, join=False,
                              args=(WORLD, str(tmp / f"store_{mode}"),
                                    str(out), str(key_path), mode == "reuse"))
    want = ref_proof_to_dict(ref.prove_committed(
        rpk, _ref_build, rng=random.Random(11), r_rand=5, s_rand=9))
    ranks.join_all(ctxs.values(), JOIN_S)
    return {"got": {mode: ranks.results(tmp / mode, WORLD) for mode in MODES},
            "want": want, "port": port, "pk": pk}


def test_blind_reaches_the_commitment(runs):
    """The blind's commitment base is not the identity, so ranks with
    different blinds could not return the single-device proof."""
    port = runs["port"]
    assert not runs["pk"].k_commit_g1.to_host_points(port.dc)[-1].infinity


@pytest.mark.parametrize("mode", MODES)
def test_sharded_committed_prove_equals_single_device(runs, mode):
    """Each rank's proof (a, b, c, D and pok) is the reference's
    single-device proof with rank 0's blind, though the ranks drew
    different blinds; no rank imported jax."""
    got = runs["got"][mode]
    assert got[0]["committed"]["own_blind"] != got[1]["committed"]["own_blind"]
    for res in got:
        assert res["committed"]["proof"] == runs["want"]
        assert res["jax"] == []


@pytest.mark.parametrize("mode", MODES)
def test_sharded_committed_proof_verifies(runs, mode):
    """The ranks' proof verifies (rank 0) and is refused for public + 1
    (rank 1)."""
    got = runs["got"][mode]
    assert got[0]["committed"]["verified"] and got[1]["committed"]["refused"]
