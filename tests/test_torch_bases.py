"""`EncodedBases.from_host_points` and `drop_device` of davinci_tpu_torch
held against the JAX package on the CPU: host points of BN254 G1 and G2
(the point at infinity among them) encode to the reference's arrays, no
points to its empty bases, and dropping the device caches makes the next
`device(...)` upload the same tensors again."""

import random

import numpy as np
import pytest
import torch

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.groth16.bases import EncodedBases as RefBases
from davinci_tpu_torch import curves as C
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.groth16.bases import EncodedBases

torch.set_num_threads(1)

CURVES = [("g1", C.bn254_g1, RC.bn254_g1), ("g2", C.bn254_g2, RC.bn254_g2)]


def _points(spec, n, seed):
    rng = random.Random(seed)
    pts = [spec.gen.mul(rng.randrange(1, spec.r)) for _ in range(n)]
    pts[2] = spec.infinity()
    return pts


def _same(got, want):
    for a, b in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        assert a.dtype == np.int32 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name,spec,rspec", CURVES)
def test_from_host_points_matches_reference(name, spec, rspec):
    pts = _points(spec, 6, len(name))
    rpts = _points(rspec, 6, len(name))
    got = EncodedBases.from_host_points(get_device_curve(spec, "cpu"), pts)
    _same(got, RefBases.from_host_points(ref_curve(rspec), rpts))
    assert len(got) == 6
    assert got.to_host_points(get_device_curve(spec, "cpu")) == pts


@pytest.mark.parametrize("name,spec,rspec", CURVES)
def test_from_no_points_is_empty(name, spec, rspec):
    dc = get_device_curve(spec, "cpu")
    got = EncodedBases.from_host_points(dc, [])
    assert got == EncodedBases.empty(dc) and len(got) == 0
    _same(got, RefBases.from_host_points(ref_curve(rspec), []))


def test_drop_device_uploads_again():
    dc = get_device_curve(C.bn254_g1, "cpu")
    bases = EncodedBases.from_host_points(dc, _points(C.bn254_g1, 5, 1))
    first = bases.device("cpu")
    packed = bases.device_packed("cpu", dc)
    assert bases.device("cpu") is first
    bases.drop_device()
    again = bases.device("cpu")
    assert again is not first
    for a, b in zip(again, first):
        assert torch.equal(a, b)
    packed2 = bases.device_packed("cpu", dc)
    assert packed2 is not packed
    for a, b in zip(packed2, packed):
        assert torch.equal(a, b)
