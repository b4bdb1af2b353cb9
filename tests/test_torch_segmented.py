"""Streamed segments: a proving-key set above a segment runs segment by
segment, each uploaded from the host arrays and freed after its MSM
(`Groth16._msm_enc_segmented`), as the reference's does; no such set is
kept on the device.  Held against the JAX package on the CPU.

The port proves the lookup range circuit of `torch_committed_cases`
with the reference's key (tests/vectors/committed_bn254.json),
random.Random(11), r = 5 and s = 9, on a `Groth16` whose segments are
SEGMENT_G1 and SEGMENT_G2 points, so that the key's largest G1 set (h,
31 points, two segments) and its G2 set (b2, 9 points, two segments)
are streamed.  Its committed proof must be the reference's, limb for
limb (a, b, c, D and pok): the vector's, which
test_torch_committed_ref.py holds the reference's own prove to (a
segment's plain MSM on the CPU walks every bit of its largest scalar,
so each segment costs about a set's MSM: the reference's prove, and
segments on every set, would take the file past half a minute).  The
witness reduction's carries and fold, which run a block of rows at a
time (`witness_dev._ROWS`), give the reference's limbs with blocks of
four rows.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.groth16 import witness_dev as ref_wd
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu.ntt import get_device_ntt as ref_ntt
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16, witness_dev
from davinci_tpu_torch.groth16.bases import EncodedBases
from davinci_tpu_torch.groth16.core import _segment_uploads
from davinci_tpu_torch.groth16.serialize import pk_from_bytes, proof_to_dict
from davinci_tpu_torch.msm.pippenger import pack_scalars, unpack_limbs
from davinci_tpu_torch.ntt import get_device_ntt

import torch_committed_cases as cc

torch.set_num_threads(1)

# the key's G1 sets hold 9-31 points, its G2 set 9: h and b2 split in two
SEGMENT_G1 = 16
SEGMENT_G2 = 8
STREAMED = {"z_g1": 31, "b_g2": 9}


@pytest.fixture(scope="module")
def run():
    """The port's segmented committed prove, the length of every set
    that took the segmented path, and the reference's proof."""
    port = Groth16("bn254", device="cpu")
    port.MSM_SEGMENT, port.MSM_SEGMENT_G2 = SEGMENT_G1, SEGMENT_G2
    segmented = []
    whole = port._msm_enc_segmented

    def recorded(dc, gspec, bases, S_full, seg):
        segmented.append(len(bases))
        return whole(dc, gspec, bases, S_full, seg)

    port._msm_enc_segmented = recorded
    want = cc.vector()
    pk = pk_from_bytes(bytes.fromhex(want["pk"]), port.g1, port.g2)
    got = cc.prove("davinci_tpu_torch", port, pk)
    return dict(pk=pk, segmented=segmented, want=want["proof"],
                got=proof_to_dict(got))


@pytest.mark.parametrize("part", ["a", "b", "c", "d", "pok"])
def test_segmented_proof_equals_reference(run, part):
    assert run["got"][part] == run["want"][part]


def test_the_largest_sets_took_the_segmented_path(run):
    assert {name: len(getattr(run["pk"], name)) for name in STREAMED} \
        == STREAMED
    assert sorted(run["segmented"]) == sorted(STREAMED.values())


def test_no_segmented_set_is_kept_on_the_device(run):
    for name, b in vars(run["pk"]).items():
        if isinstance(b, EncodedBases):
            kept = torch.device("cpu") in b._dev
            assert kept == (name not in STREAMED), name
            assert not (name in STREAMED and b._packed), name


def test_segment_uploads_are_the_host_slices():
    """Each span comes back as the host arrays' rows, in order; no span,
    nothing."""
    rng = np.random.default_rng(5)
    x, y, z = (rng.integers(0, 1 << 12, (11, 2, 4), dtype=np.int32)
               for _ in range(3))
    bases = EncodedBases(x, y, z)
    spans = [(0, 4), (8, 11), (4, 8)]
    got = list(_segment_uploads(bases, spans, torch.device("cpu")))
    assert len(got) == len(spans)
    for arrs, (ofs, hi) in zip(got, spans):
        for t, a in zip(arrs, (x, y, z)):
            assert np.array_equal(t.numpy(), a[ofs:hi])
    assert list(_segment_uploads(bases, [], torch.device("cpu"))) == []
    assert not bases._dev


def test_witness_rows_in_blocks_equal_the_reference(monkeypatch):
    """(A z, B z, C z) with the carries and the fold four rows at a time,
    over a domain of 32 rows: the reference's limbs, and satisfied."""
    r = random.Random(3)
    cs = ConstraintSystem(TF.BN254_R)
    y = cs.pub_input(0)
    acc = cs.priv_input(r.randrange(1, TF.BN254_R))
    for i in range(20):
        k = r.randrange(1, TF.BN254_R) if i % 3 == 0 else r.randrange(1, 9)
        acc = cs.mul(acc * k + i, acc + 5)
    cs.values[1] = acc.value
    cs.assert_eq(acc, y)
    z, mats, N = cs.witness(), cs._flat_matrices(), 32
    assert len(cs.constraints) <= N
    W = -(-TF.BN254_R.bit_length() // 12)
    packed = pack_scalars(TC.bn254_g1, z)
    df = get_device_ntt(TF.bn254_fr, "cpu").df
    monkeypatch.setattr(witness_dev, "_ROWS", 4)
    got = witness_dev.matvec_device(
        df, witness_dev.DeviceCSR(mats, TF.BN254_R, df.L, "cpu"),
        unpack_limbs(torch.as_tensor(packed.view(np.int32)), W), N)
    rdf = ref_ntt(RF.bn254_fr).df
    want = ref_wd.matvec_device(
        rdf, ref_wd.DeviceCSR(mats, TF.BN254_R, rdf.L),
        rpp.unpack_limbs(jnp.asarray(packed), W), N)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert bool(witness_dev.satisfied_device(df, *got, len(cs.constraints)))
