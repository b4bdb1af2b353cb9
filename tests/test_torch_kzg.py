"""The blob KZG path of davinci_tpu_torch (blobs/, state/blobcodec.py) held
against the JAX package on the CPU.

The host functions must give the reference's bytes and ints; the
BLS12-381 G1 MSM (L = 32) must equal the reference's `msm` and a host sum;
a sparse blob's commitment through the port's `kzg`, on the scan path with
its plain kernels (the route the card takes, shrunk to a scan width of 16
as tests/test_torch_msm_scan.py does), must equal the host oracle
sum_i c_i G_i over the ceremony's Lagrange points.  Inputs are made from
seeds on the host.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.blobs import kzg as rkzg
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.msm import msm as ref_msm
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu.state import blobcodec as rcodec
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import spec
from davinci_tpu_torch.blobs import kzg
from davinci_tpu_torch.blobs.setup import load_trusted_setup
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import msm
from davinci_tpu_torch.msm import pippenger as pp
from davinci_tpu_torch.state import blobcodec

torch.set_num_threads(1)

R = kzg.R


def _coords(pt):
    return None if pt.infinity else (pt.x.v, pt.y.v)


def _cells(n, seed):
    r = random.Random(seed)
    return [r.randrange(R) for _ in range(n)]


def test_blob_bytes_match_reference():
    cells = _cells(300, 1)
    ours, ref = kzg.Blob(cells), rkzg.Blob(cells)
    assert ours.to_bytes() == ref.to_bytes()
    assert kzg.Blob.from_bytes(ref.to_bytes()).cells == ref.cells
    assert kzg._domain() == rkzg._domain()


@pytest.mark.parametrize("where", ["random", "in_domain"])
def test_barycentric_matches_reference(where):
    cells = _cells(64, 2)
    z = random.Random(3).randrange(R) if where == "random" else kzg._domain()[5]
    want = rkzg.evaluate_barycentric(rkzg.Blob(cells), z)
    assert kzg.evaluate_barycentric(kzg.Blob(cells), z) == want
    if where == "in_domain":
        assert want == cells[5]


def test_evaluation_point_hash_and_compression_match_reference():
    com = bytes(range(48))
    assert (kzg.compute_evaluation_point(123, 456, com)
            == rkzg.compute_evaluation_point(123, 456, com))
    assert kzg.split_48b_to_limbs(com) == rkzg.split_48b_to_limbs(com)
    assert kzg.versioned_hash(com) == rkzg.versioned_hash(com)
    r = random.Random(4)
    for pt in [TC.bls381_g1.gen.mul(r.randrange(1, R)) for _ in range(3)]:
        ref_pt = RC.bls381_g1.point(pt.x.v, pt.y.v)
        assert kzg.compress_g1(pt) == rkzg.compress_g1(ref_pt)
    assert (kzg.compress_g1(TC.bls381_g1.infinity())
            == rkzg.compress_g1(RC.bls381_g1.infinity()))


class _Coords(SimpleNamespace):
    def coords(self):
        return list(self.values)


def _batch(n_votes, seed):
    """A synthetic BatchResult: the attributes pack_batch_blob reads."""
    r = random.Random(seed)
    coords = lambda: _Coords(values=[r.randrange(R)
                                     for _ in range(blobcodec.COORDS)])
    votes = [SimpleNamespace(vote_id=r.randrange(R), address=r.randrange(2**160),
                             ballot_index=r.randrange(2**32),
                             weight=r.randrange(2**64),
                             reencrypted_ballot=coords())
             for _ in range(n_votes)]
    return SimpleNamespace(new_results=coords(), voters_count=n_votes,
                           votes=votes, root_before=r.randrange(R))


def test_pack_batch_blob_matches_reference():
    batch = _batch(spec.VOTES_PER_BATCH, 5)
    got = blobcodec.pack_batch_blob(7, batch)
    assert got == rcodec.pack_batch_blob(7, batch)
    assert got["n_cells"] == 33 + 60 * 36
    parsed = blobcodec.parse_blob_data(bytes.fromhex(got["blob_hex"]))
    assert parsed["voters_count"] == 60
    assert parsed["votes"][59]["weight"] == batch.votes[59].weight


def test_bls381_msm_matches_reference_and_host():
    """The port's BLS12-381 G1 msm on CPU tensors (the plain route) equals
    the reference's msm (its CPU route) and the host sum, at n = 24 with
    scalars 0, 1 and r - 1 and an infinity base."""
    g1 = TC.bls381_g1
    r = random.Random(6)
    pts = [g1.gen.mul(r.randrange(1, R)) for _ in range(24)]
    pts[4] = g1.infinity()
    scalars = [r.randrange(R) for _ in pts]
    scalars[:3] = [0, 1, R - 1]
    dc = get_device_curve(g1, "cpu")
    S = pp.scalars_to_limbs(g1, scalars)
    got = dc.decode_points(tuple(a[None] for a in msm(
        dc, dc.encode_points(pts), torch.as_tensor(S))))[0]
    Rc = ref_curve(RC.bls381_g1)
    P = tuple(jnp.asarray(a.numpy()) for a in dc.encode_points(pts))
    want = Rc.decode_points(tuple(a[None] for a in ref_msm(
        Rc, P, jnp.asarray(rpp.scalars_to_limbs(RC.bls381_g1, scalars)))))[0]
    host = g1.infinity()
    for p, s in zip(pts, scalars):
        host = host.add(p.mul(s))
    assert got == host
    assert _coords(want) == _coords(host)


@pytest.mark.heavy  # decompresses the 4,096-point setup: about 20 s in all
def test_sparse_blob_commitment_on_the_scan_path(monkeypatch):
    """Five nonzero cells: the commitment through `blob_to_commitment`, with
    the pipeline forced on for CPU tensors (every kernel wrapper runs its
    plain version), equals the host oracle's compressed sum."""
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: True)
    monkeypatch.setattr(pp, "COLS", 16)
    monkeypatch.setattr(bk, "REDUCE_C", 32)
    scans = []
    real_scan = pp._msm_scan
    monkeypatch.setattr(
        pp, "_msm_scan", lambda *a, **k: scans.append(k) or real_scan(*a, **k))
    g1_brp, _ = load_trusted_setup()
    cells = _cells(5, 7)
    want = TC.bls381_g1.infinity()
    for c, g in zip(cells, g1_brp):
        want = want.add(g.mul(c))
    assert kzg.blob_to_commitment(kzg.Blob(cells), "cpu") == kzg.compress_g1(want)
    assert len(scans) == 1 and scans[0]["precomp"] is not None
    dc, pts, (packed, is_inf) = kzg._setup_device_points("cpu")
    assert dc.df.L == 32 and packed.shape == (4096, 24) and not is_inf.any()
    assert np.array_equal(pts[2].numpy(), dc.ops.one_mont.expand(4096, 32).numpy())


def test_blob_entry_points_default_to_the_card():
    import inspect

    for fn in (kzg.blob_to_commitment, kzg.compute_kzg_proof,
               kzg._setup_device_points):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
