"""The EIP-7594 cell proofs of davinci_tpu_torch (blobs/cells.py) and the
batched MSM under them (`msm_many`, `msm_host_input` in msm/pippenger.py)
held against the JAX package on the CPU.

`msm_many` on BLS12-381 G1, the cells' curve, by the card's route of
tests/torch_msm_many_cases.py (its plain route and `msm_host_input` in
tests/test_torch_msm_many.py, BN254 G1 in
tests/test_torch_msm_many_bn254.py).  The steps of `compute_cell_proofs_device`
are held on the CPU with its MSM stopped before it runs: the
coefficients equal `blob_to_coeffs`, the quotients of two cells the host
recurrence, the bit-reversed evaluations the host NTT's.  The whole
device proof of two cells, equal to the reference's host
`compute_cell_proof`, runs with RUN_SLOW_TESTS (a 4,096-point plain MSM
a cell on the CPU).  Tolerance: exact equality of limbs, ints, points and
bytes.
"""

import os
import random

import numpy as np
import pytest
import torch

import torch_msm_many_cases as cases
from davinci_tpu.blobs import cells as rcells
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import fields as F
from davinci_tpu_torch import msm as port_msm
from davinci_tpu_torch.blobs import cells
from davinci_tpu_torch.blobs import kzg
from davinci_tpu_torch.ff import get_device_field
from davinci_tpu_torch.msm import pippenger as pp
from davinci_tpu_torch.ntt.ntt import DeviceNTT

torch.set_num_threads(1)

R = F.BLS12_381_R


def test_msm_package_exports():
    assert port_msm.__all__ == ["msm", "msm_host_input", "msm_many",
                                "sharded_msm"]
    assert port_msm.msm_many is pp.msm_many
    assert port_msm.msm_host_input is pp.msm_host_input
    assert port_msm.sharded_msm is pp.sharded_msm


def test_msm_many_scan_route_matches_reference(monkeypatch):
    cases.check_scan_route("bls381_g1", monkeypatch)


# -- compute_cell_proofs_device ------------------------------------------------


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def blob():
    rng = random.Random(0x7594)
    return cells.Blob([rng.randrange(R) for _ in range(cells.BLOB_CELLS)])


def test_cell_proofs_device_resolves():
    """The sequencer's blob path imports it by this name
    (`sequencer/pipeline.py`, `cli.py`'s send-blob --cells)."""
    from davinci_tpu_torch.blobs.cells import compute_cell_proofs_device

    assert compute_cell_proofs_device.__module__ == cells.__name__


def test_cell_proof_steps_match_host(blob, monkeypatch):
    """The device path's steps for cells 3 and 64, up to its MSM: the
    iNTT's coefficients are `blob_to_coeffs`; the NTT's input holds each
    cell's quotient by the host recurrence q[k] = p[k+64] + c q[k+64];
    the MSM's scalars are the host NTT of each quotient in bit-reversed
    order, as raw base-2^12 limbs over the Lagrange setup's points."""
    ids = [3, 64]
    df = get_device_field(F.bls12_381_fr, "cpu")
    seen = {}
    real_intt, real_ntt = DeviceNTT.intt_with_root, DeviceNTT.ntt_with_root

    def intt(self, x, w):
        seen["coeffs"] = real_intt(self, x, w)
        return seen["coeffs"]

    def ntt(self, x, w):
        seen["ntt_in"] = x
        return real_ntt(self, x, w)

    monkeypatch.setattr(DeviceNTT, "intt_with_root", intt)
    monkeypatch.setattr(DeviceNTT, "ntt_with_root", ntt)
    monkeypatch.setattr(kzg, "_setup_device_points",
                        lambda device: ("curve", "points", "planes"))

    def stop(curve, points, scalars, precomp=None):
        seen["msm"] = (curve, points, precomp, scalars)
        raise _Stop

    monkeypatch.setattr(port_msm, "msm_many", stop)
    with pytest.raises(_Stop):
        cells.compute_cell_proofs_device(blob, ids, device="cpu")

    coeffs = rcells.blob_to_coeffs(blob)
    assert df.decode(seen["coeffs"]) == coeffs
    assert coeffs == cells.blob_to_coeffs(blob)
    q_dev = seen["ntt_in"]
    assert q_dev.shape == (2, cells.BLOB_CELLS, df.L)
    w4096 = cells._dom4096_standard()[1]
    curve, points, precomp, scalars = seen["msm"]
    assert (curve, points, precomp) == ("curve", "points", "planes")
    assert scalars.shape == (2, cells.BLOB_CELLS, 22)
    for m, cid in enumerate(ids):
        c = cells._cell_vanishing_constant(cid)
        q = [0] * cells.BLOB_CELLS
        for k in range(cells.BLOB_CELLS - 1 - 64, -1, -1):
            q[k] = (coeffs[k + 64] + c * q[k + 64]) % R
        assert df.decode(q_dev[m]) == q
        evals = rcells._ntt_host(q, w4096)
        brp = [evals[cells._brp(i, 12)] for i in range(cells.BLOB_CELLS)]
        want = pp.scalars_to_limbs(TC.bls381_g1, brp)
        assert np.array_equal(scalars[m].numpy(), want)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW_TESTS"),
                    reason="two 4,096-point plain MSMs and the reference's "
                           "host proofs: minutes on the CPU")
def test_device_cell_proofs_match_reference_host(blob):
    ids = [3, 64]
    got = cells.compute_cell_proofs_device(blob, ids, device="cpu")
    rblob = rcells.Blob(blob.cells)
    for cid, proof in zip(ids, got):
        assert proof == rcells.compute_cell_proof(rblob, cid)
