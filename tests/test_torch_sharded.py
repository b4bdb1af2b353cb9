"""Multi-card proving of davinci_tpu_torch (`parallel/mesh.py`, the
four-step `sharded_ntt`, `sharded_msm`, `Groth16.set_mesh`) held against
the single-device results and the JAX package, on the CPU.

The reference is single-controller `shard_map` over a device mesh; the
port is SPMD, one process per rank.  So the ranks run in spawned
processes joined in a gloo group through a `file://` store under the
test's temporary directory (no TCP port, which parallel test workers
would share), with a 60 s collective timeout: `tests/torch_sharded_ranks.py`,
which imports only the port.  One spawn per world size, D = 2 and D = 4,
both at once, runs every case and writes its results; meanwhile this
process computes the reference's: its `ntt`, its `sharded_ntt` on a
4-device slice of the virtual mesh (tests/conftest.py), the host MSM and
its single-device proof.  The key is the reference's, carried across by
`convert.py`.  On CPU tensors every kernel wrapper runs its plain
version, so these pin the sharded algorithm the card runs.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_sharded_ranks as ranks

from davinci_tpu import fields as RF
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu_torch import convert
from davinci_tpu_torch import curves as C
from davinci_tpu_torch import fields as F
from davinci_tpu_torch.ff import get_device_field
from davinci_tpu_torch.parallel import distributed_init

WORLDS = (2, 4)
JOIN_S = 240  # the spawns' deadline; each collective times out at 60 s


def _host_msm(pts, scalars):
    acc = C.bn254_g1.infinity()
    for pt, s in zip(pts, scalars):
        acc = acc.add(pt.mul(s))
    return acc


def _reference(ref, rcs, rpk, rvk):
    """The reference's transforms, the host MSMs and the reference's
    proof (r = 5, s = 9)."""
    import jax
    import jax.numpy as jnp
    from davinci_tpu.ntt import get_device_ntt as ref_ntt

    out = {"ntt": {}}
    rntt = ref_ntt(RF.bn254_fr)
    df = get_device_field(F.bn254_fr, "cpu")
    mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("shard",))
    for n in ranks.NTT_SIZES:
        x = jnp.asarray(df.encode(ranks.ntt_inputs(n, F.bn254_fr)).numpy())
        out["ntt"][n] = {
            "ntt": np.asarray(rntt.ntt(x)), "intt": np.asarray(rntt.intt(x)),
            "sharded4": np.asarray(rntt.sharded_ntt(x, mesh4)),
            "sharded4_inv": np.asarray(rntt.sharded_intt(x, mesh4)),
        }
    out["msm"] = ranks._coords(_host_msm(*ranks.msm_inputs(C.bn254_g1)))
    bases, eta, vals = ranks.commit_inputs(C.bn254_g1)
    out["commit"] = tuple(ranks._coords(_host_msm(b, vals)) for b in (bases, eta))
    proof = ref.prove(rpk, rcs, r_rand=5, s_rand=9)
    out["proof"] = tuple(ranks._coords(getattr(proof, k)) for k in "abc")
    out["verified"] = ref.verify(rvk, proof, rcs.public_values())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: [rank results]} of both spawns and the reference's results."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref = RefGroth16("bn254")
    rcs = ranks.prove_circuit(RefCS, RF.BN254_R)
    rpk, rvk = ref.setup(rcs)
    g1, g2 = C.bn254_g1, C.bn254_g2
    key_path = tmp / "key.pkl"
    with open(key_path, "wb") as f:
        pickle.dump((convert.proving_key_from_reference(rpk, g1, g2),
                     convert.verifying_key_from_reference(rvk, g1, g2)), f)
    ctxs = {}
    for D in WORLDS:
        out = tmp / f"world{D}"
        out.mkdir()
        ctxs[D] = mp.spawn(ranks.run, nprocs=D, join=False, args=(
            D, str(tmp / f"store{D}"), str(out), str(key_path)))
    want = _reference(ref, rcs, rpk, rvk)
    ranks.join_all(ctxs.values(), JOIN_S)
    got = {D: ranks.results(tmp / f"world{D}", D) for D in WORLDS}
    return {"got": got, "want": want}


@pytest.mark.parametrize("D", WORLDS)
def test_mesh_blocks_and_ranks_without_jax(runs, D):
    """Each rank's mesh has D ranks and its contiguous block; uneven rows
    are refused; every rank gets rank 0's broadcast values; no rank
    imported jax or the JAX package."""
    for r, res in enumerate(runs["got"][D]):
        assert res["mesh"] == {"size": D, "uneven_refused": True,
                               "block": [3 * r, 3 * r + 1, 3 * r + 2],
                               "broadcast": [0, 0]}
        assert res["jax"] == []


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("n", ranks.NTT_SIZES)
def test_sharded_ntt_matches_single_device_and_reference(runs, D, n):
    """The ranks' blocks of sharded_ntt / sharded_intt, put together, are
    the port's ntt / intt, the reference's, and at D = 4 the reference's
    own four-step transform, limb for limb (the last eight inputs are
    p - 1 ... p - 8)."""
    want = runs["want"]["ntt"][n]
    fwd = np.concatenate([res["ntt"][n]["fwd"] for res in runs["got"][D]])
    inv = np.concatenate([res["ntt"][n]["inv"] for res in runs["got"][D]])
    for res in runs["got"][D]:
        assert np.array_equal(res["ntt"][n]["fwd"], res["ntt"][n]["ntt"])
        assert np.array_equal(res["ntt"][n]["inv"], res["ntt"][n]["intt"])
    assert np.array_equal(fwd, want["ntt"]) and np.array_equal(inv, want["intt"])
    assert np.array_equal(want["sharded4"], want["ntt"])
    assert np.array_equal(want["sharded4_inv"], want["intt"])


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("route", ("plain", "scan"))
def test_sharded_msm_matches_host_oracle(runs, D, route):
    """Every rank returns the host MSM of 45 points (padded to D blocks),
    on the plain route and on the scan route, each taken once."""
    for res in runs["got"][D]:
        assert res["msm"][route] == runs["want"]["msm"]
        assert res["msm"]["routes"] == {"plain": 1, "scan": 1}


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_prove_matches_reference(runs, D):
    """test_groth16_sharded.py's 40-product circuit proved with set_mesh
    on every rank: the reference's single-device proof from the same key
    (r = 5, s = 9), verified (on rank 0), and refused for public + 1 (on
    rank 1)."""
    assert runs["want"]["verified"]
    for res in runs["got"][D]:
        assert res["prove"]["proof"] == runs["want"]["proof"]
    got = runs["got"][D]
    assert got[0]["prove"]["verified"] and got[1]["prove"]["refused"]


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_commitment_msms_match_host(runs, D):
    """A committed prove's D and pok (`Groth16._commit`) with the mesh set,
    over bases from `EncodedBases.from_host_points`: the host MSMs."""
    for res in runs["got"][D]:
        assert res["prove"]["commit"] == runs["want"]["commit"]


def test_distributed_init_without_address_is_a_no_op():
    distributed_init(None)
    assert not dist.is_initialized()
