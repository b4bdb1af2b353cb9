"""The ranks of tests/test_torch_sharded.py: one process per rank of a
gloo group on the CPU, each running every sharded case of the port and
writing what it got to `<out>/rank<r>.pkl` for the test to compare.

It imports the port and never the JAX package, so a spawned rank stays
small; the test holds the results against the reference in its own
process.  Cases (`run`):

  * ntt: `sharded_ntt` / `sharded_intt` at n = 2^6 and 2^8 (and near p)
    on this rank's block, beside the port's single-device `ntt` / `intt`
    of the whole vector;
  * msm: `sharded_msm` on the plain route, and on the scan route (the
    pipeline forced on for CPU tensors, at the 4-bit windows of
    test_torch_msm_scan.py's `four_bit`: COLS 16, REDUCE_C 4, 16 buckets,
    8 signed), n not a multiple of COLS * D;
  * mesh: `shard_batch`'s blocks, rows that do not split evenly refused,
    `broadcast_objects` (the prove's shared blinding) giving rank 0's;
  * prove: the key carried across from the reference proved with
    `set_mesh` (r = 5, s = 9), verified on rank 0 and refused for public
    + 1 on rank 1 (the ranks' proofs are compared equal); and the
    committed proves' own MSMs (`Groth16._commit`: D and pok over
    commitment bases made by `EncodedBases.from_host_points`) with the
    mesh set.

`run_committed` is the ranks of tests/test_torch_sharded_committed.py:
a whole committed prove with the mesh set, `prove_committed` or
`prove_committed_reuse` of `blinded_range_circuit`.
"""

from __future__ import annotations

import importlib
import pickle
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import torch_committed_cases as cc

NTT_SIZES = (1 << 6, 1 << 8)
MSM_N = 45  # not a multiple of COLS * D for D = 2, 4 at COLS = 16
SEED = 0x5A4D


def ntt_inputs(n, spec):
    """Random values below p, the last eight near p, as ints."""
    rng = random.Random(SEED + n)
    vals = [rng.randrange(spec.p) for _ in range(n)]
    vals[-8:] = [spec.p - 1 - i for i in range(8)]
    return vals


def msm_inputs(spec, n=MSM_N):
    """n host points (a random point and a random step's sums) and
    scalars, some 0, 1 and r - 1."""
    rng = random.Random(SEED)
    pt = spec.gen.mul(rng.randrange(1, spec.r))
    step = spec.gen.mul(rng.randrange(1, spec.r))
    pts = [pt]
    for _ in range(n - 1):
        pts.append(pts[-1].add(step))
    scalars = [rng.randrange(spec.r) for _ in range(n)]
    scalars[:3] = [0, 1, spec.r - 1]
    return pts, scalars


def commit_inputs(spec):
    """Seven commitment bases, their eta multiples (here: the bases
    reversed) and small committed values, 0 among them."""
    pts, _ = msm_inputs(spec, n=7)
    return pts, pts[::-1], [0, 1, 2, 3 << 20, 5, 7 << 9, 11]


def prove_circuit(CS, R):
    """tests/test_groth16_sharded.py's circuit: 40 chained products."""
    rng = random.Random(0xD1)
    cs = CS(R)
    y = cs.pub_input(0)
    acc = cs.priv_input(rng.randrange(1, 1 << 60))
    for _ in range(40):
        acc = cs.mul(acc, acc + 1)
    cs.values[1] = acc.value  # patch the public to the computed value
    cs.assert_eq(acc, y)
    return cs


def _coords(pt):
    return None if pt.infinity else (pt.x.v, pt.y.v)


def _ntt_cases(mesh):
    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.ntt import get_device_ntt
    from davinci_tpu_torch.parallel.mesh import shard_batch

    ntt = get_device_ntt(F.bn254_fr, "cpu")
    out = {}
    for n in NTT_SIZES:
        x = ntt.df.encode(ntt_inputs(n, F.bn254_fr))
        blk = shard_batch(mesh, x)
        out[n] = {
            "fwd": ntt.sharded_ntt(blk, mesh).numpy(),
            "inv": ntt.sharded_intt(blk, mesh).numpy(),
            "ntt": shard_batch(mesh, ntt.ntt(x)).numpy(),
            "intt": shard_batch(mesh, ntt.intt(x)).numpy(),
        }
    return out


# the scan route's shrunk pipeline: module attributes of pippenger (pp)
# and bucket_kernel (bk)
FOUR_BIT = {"pp": {"COLS": 16, "WINDOW_BITS": 4, "NBUCKETS": 16,
                   "SIGNED_NBUCKETS": 8, "_use_pipeline": lambda device: True},
            "bk": {"REDUCE_C": 4}}


def _msm_cases(mesh):
    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm import bucket_kernel as bk
    from davinci_tpu_torch.msm import pippenger as pp
    from davinci_tpu_torch.msm import sharded_msm

    spec = C.bn254_g1
    dc = get_device_curve(spec, "cpu")
    pts, scalars = msm_inputs(spec)
    P = tuple(a.numpy() for a in dc.encode_points(pts))
    routes = {}
    mods = {"pp": pp, "bk": bk}
    saved = {k: {a: getattr(mods[k], a) for a in v} for k, v in FOUR_BIT.items()}
    saved["pp"]["_msm_plain"] = pp._msm_plain
    saved["bk"]["bucket_accumulate_packed"] = bk.bucket_accumulate_packed

    def counted(name, fn):
        def call(*a, **k):
            routes[name] = routes.get(name, 0) + 1
            return fn(*a, **k)
        return call

    pp._msm_plain = counted("plain", pp._msm_plain)
    bk.bucket_accumulate_packed = counted("scan", bk.bucket_accumulate_packed)
    out = {}
    try:
        for route in ("plain", "scan"):
            if route == "scan":
                for k, v in FOUR_BIT.items():
                    for a, val in v.items():
                        setattr(mods[k], a, val)
            S = pp.scalars_to_limbs(spec, scalars)
            got = sharded_msm(dc, P, S, mesh)
            out[route] = _coords(dc.decode_points(tuple(a[None] for a in got))[0])
    finally:
        for k, v in saved.items():
            for a, val in v.items():
                setattr(mods[k], a, val)
    out["routes"] = routes
    return out


def _mesh_cases(mesh):
    from davinci_tpu_torch.parallel import shard_batch
    from davinci_tpu_torch.parallel.mesh import axis_size

    D = axis_size(mesh)
    try:
        shard_batch(mesh, torch.zeros((D * 3 + 1, 1)))
        uneven = False
    except ValueError:
        uneven = True
    from davinci_tpu_torch.parallel.mesh import axis_rank, broadcast_objects

    rank = axis_rank(mesh)
    return {"size": D, "uneven_refused": uneven,
            "block": shard_batch(mesh, torch.arange(D * 3)).tolist(),
            "broadcast": broadcast_objects(mesh, [rank, -rank])}


def _prove_cases(mesh, key_path):
    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16
    from davinci_tpu_torch.groth16.bases import EncodedBases

    with open(key_path, "rb") as f:
        pk, vk = pickle.load(f)
    cs = prove_circuit(ConstraintSystem, F.BN254_R)
    from davinci_tpu_torch.parallel.mesh import axis_rank

    g16 = Groth16("bn254", device="cpu")
    g16.set_mesh(mesh)
    sharded = g16.prove(pk, cs, r_rand=5, s_rand=9)
    out = {"proof": tuple(_coords(getattr(sharded, k)) for k in "abc")}
    # one CPU verify costs seconds: rank 0 verifies, rank 1 refuses
    rank = axis_rank(mesh)
    if rank == 0:
        out["verified"] = g16.verify(vk, sharded, cs.public_values())
    if rank == 1:
        out["refused"] = not g16.verify(vk, sharded,
                                        [cs.public_values()[0] + 1])
    bases, eta, vals = commit_inputs(g16.g1)
    keys = SimpleNamespace(
        k_commit_g1=EncodedBases.from_host_points(g16.dc, bases),
        k_commit_eta_g1=EncodedBases.from_host_points(g16.dc, eta))
    d, pok = g16._commit(keys, vals)
    out["commit"] = (_coords(d), _coords(pok))
    return out


def _in_group(rank, world, store, out_dir, cases):
    """Join the gloo group through the file store, run `cases` ((name,
    fn of the mesh), ...) with each one's seconds, and write the results
    to `<out_dir>/rank<rank>.pkl`."""
    torch.set_num_threads(1)
    from davinci_tpu_torch.parallel import distributed_init, get_mesh

    distributed_init(f"file://{store}", world, rank, backend="gloo",
                     timeout=60)
    try:
        mesh = get_mesh("shard", device="cpu")
        res = {"seconds": {}}
        for name, case in cases:
            t0 = time.perf_counter()
            res[name] = case(mesh)
            res["seconds"][name] = time.perf_counter() - t0
        res["jax"] = [m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "davinci_tpu")]
    finally:
        torch.distributed.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def run(rank, world, store, out_dir, key_path):
    """One rank of tests/test_torch_sharded.py: every case."""
    _in_group(rank, world, store, out_dir, (
        ("mesh", _mesh_cases), ("ntt", _ntt_cases), ("msm", _msm_cases),
        ("prove", lambda mesh: _prove_cases(mesh, key_path))))


def blinded_range_circuit(pkg, challenge, blind):
    """torch_committed_cases' lookup range circuit, built by package
    `pkg`, with its `_refinalize` hook and its blind wire in a constraint
    (blind * 1 == blind).  In the plain circuit the blind's commitment
    base is the identity, so the blind reaches no MSM; here it reaches D,
    pok and the A MSM, and ranks with different blinds would sum blocks
    of different witnesses."""
    F = importlib.import_module(f"{pkg}.fields")
    r1cs = importlib.import_module(f"{pkg}.groth16.r1cs")
    lookup = importlib.import_module(f"{pkg}.circuits.lookup")
    cs = r1cs.ConstraintSystem(F.BN254_R)
    marker = cs.pub_input(7)
    rc = lookup.LookupRangeChecker(cs, table_bits=cc.TABLE_BITS)
    for v in cc.VALUES:
        rc.range_check(cs.priv_input(v), cc.TABLE_BITS)
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    b = r1cs.LinComb(cs, {cs.committed[-1]: 1})
    cs.assert_eq(b, b)
    cs.assert_eq(marker, cs.constant(7))
    return cs


def _committed_case(mesh, key_path, reuse):
    """`blinded_range_circuit` proved with the mesh set and the keys at
    key_path (r = 5, s = 9), each rank drawing from its own
    random.Random(11 + rank): every rank must return the single-device
    proof with rank 0's draw.  With `reuse`, `prove_committed_reuse` of
    a system built once with blind 0.  Rank 0 verifies the proof, rank 1
    checks that public + 1 is refused."""
    from davinci_tpu_torch.groth16 import Groth16
    from davinci_tpu_torch.groth16.serialize import proof_to_dict
    from davinci_tpu_torch.parallel.mesh import axis_rank

    with open(key_path, "rb") as f:
        pk, vk = pickle.load(f)
    g16 = Groth16("bn254", device="cpu")
    g16.set_mesh(mesh)
    rank = axis_rank(mesh)
    seed = 11 + rank

    def build(challenge, blind):
        return blinded_range_circuit("davinci_tpu_torch", challenge, blind)

    if reuse:
        proof = g16.prove_committed_reuse(pk, build(0, 0),
                                          rng=random.Random(seed),
                                          r_rand=5, s_rand=9)
    else:
        proof = g16.prove_committed(pk, build, rng=random.Random(seed),
                                    r_rand=5, s_rand=9)
    out = {"proof": proof_to_dict(proof),
           "own_blind": random.Random(seed).randrange(g16.r)}
    if rank == 0:
        out["verified"] = g16.verify_committed(vk, proof, [7])
    if rank == 1:
        out["refused"] = not g16.verify_committed(vk, proof, [8])
    return out


def run_committed(rank, world, store, out_dir, key_path, reuse):
    """One rank of tests/test_torch_sharded_committed.py."""
    _in_group(rank, world, store, out_dir, (
        ("committed", lambda mesh: _committed_case(mesh, key_path, reuse)),))


def join_all(ctxs, seconds):
    """Wait for every spawn context (`mp.spawn(..., join=False)`) up to a
    shared deadline; a rank that raises ends the others of its spawn,
    and whatever still runs at the deadline is killed."""
    deadline = time.monotonic() + seconds
    try:
        for ctx in ctxs:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError("sharded ranks did not finish")
    finally:
        for ctx in ctxs:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()


def results(out_dir, world):
    """The ranks' results, in rank order."""
    got = []
    for r in range(world):
        with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got
