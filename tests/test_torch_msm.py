"""davinci_tpu_torch MSM (msm/pippenger.py) on the CPU.

The bucket pipeline the package runs on CUDA (`_msm_fused`: sorted bucket
scan, leftover merge, bucket reduce, Horner) is driven here with its plain
point adds at a shrunken shape: a scan width of 16 and a window of 4 bits
(16 buckets), so each case takes seconds.  The window is a module
constant of the pipeline, so the algorithm is the one that runs at 12
bits.  Results are held against a host sum of `pt.mul(s)` and against
the reference package's `msm`, point for point, with the edge cases of
test_msm_pipeline.py.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.msm import msm as ref_msm
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.msm import msm
from davinci_tpu_torch.msm import pippenger as pp

torch.set_num_threads(1)


@pytest.fixture
def small_pipeline(monkeypatch):
    monkeypatch.setattr(pp, "COLS", 16)
    monkeypatch.setattr(pp, "WINDOW_BITS", 4)
    monkeypatch.setattr(pp, "NBUCKETS", 16)


def _coords(pt):
    return None if pt.infinity else (pt.x.v, pt.y.v)


def _host_msm(spec, pts, scalars):
    acc = spec.infinity()
    for p, s in zip(pts, scalars):
        acc = acc.add(p.mul(s))
    return acc


def _reference(name, P, scalars):
    """The reference package's msm on the same encoded points."""
    rspec = getattr(RC, name)
    R = ref_curve(rspec)
    Pr = tuple(jnp.asarray(a.numpy()) for a in P)
    S = jnp.asarray(rpp.scalars_to_limbs(rspec, scalars))
    return R.decode_points(tuple(a[None] for a in ref_msm(R, Pr, S)))[0]


def _check(name, pts, scalars, fn, reference=False):
    spec = getattr(TC, name)
    dc = get_device_curve(spec, "cpu")
    P = dc.encode_points(pts)
    S = torch.as_tensor(pp.scalars_to_limbs(spec, scalars))
    got = dc.decode_points(tuple(a[None] for a in fn(dc, P, S)))[0]
    assert got == _host_msm(spec, pts, scalars)
    if reference:  # G2 MSMs meet the reference in test_torch_groth16.py
        assert _coords(got) == _coords(_reference(name, P, scalars))


def _points(spec, n, seed):
    r = random.Random(seed)
    return [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(n)], r


def test_fused_g1_edge_scalars(small_pipeline):
    """Four scan rows: the scan, the leftover merge and the reduce, with
    scalars 0, 1 and r-1, a run of equal scalars (one bucket in every
    window) and an infinity point."""
    spec = TC.bn254_g1
    pts, r = _points(spec, 64, 3101)
    pts[5] = spec.infinity()
    scalars = [r.randrange(spec.r) for _ in pts]
    scalars[:3] = [0, 1, spec.r - 1]
    for i in range(8, 24):
        scalars[i] = scalars[8]
    _check("bn254_g1", pts, scalars, pp._msm_fused, reference=True)


def test_fused_g1_all_equal_buckets(small_pipeline):
    """One run spanning every column: the worst case of the emission
    logic."""
    spec = TC.bn254_g1
    pts, _ = _points(spec, 64, 77)
    _check("bn254_g1", pts, [12345678901234567890] * 64, pp._msm_fused)


def test_fused_g1_pads_to_the_scan_width(small_pipeline):
    spec = TC.bn254_g1
    pts, r = _points(spec, 21, 78)
    _check("bn254_g1", pts, [r.randrange(spec.r) for _ in pts], pp._msm_fused)


def test_fused_g2(small_pipeline):
    spec = TC.bn254_g2
    pts, r = _points(spec, 32, 32)
    scalars = [r.randrange(spec.r) for _ in pts]
    scalars[0] = spec.r - 1
    _check("bn254_g2", pts, scalars, pp._msm_fused)


@pytest.mark.parametrize("name", ["bn254_g1", "bn254_g2"])
def test_msm_on_cpu_tensors(name):
    """`msm` on CPU tensors: the plain double-and-add MSM, as the
    reference runs on its CPU backend."""
    spec = getattr(TC, name)
    pts, r = _points(spec, 5, 33)
    _check(name, pts, [0, 1, spec.r - 1] + [r.randrange(spec.r)] * 2, msm,
           reference=name == "bn254_g1")


def test_scalar_layouts_match_reference():
    spec, rspec = TC.bn254_g1, RC.bn254_g1
    r = random.Random(9)
    scalars = [0, 1, spec.r - 1, spec.r, 2 * spec.r + 5] + [
        r.randrange(spec.r) for _ in range(11)]
    S = pp.scalars_to_limbs(spec, scalars)
    assert np.array_equal(S, rpp.scalars_to_limbs(rspec, scalars))
    packed = pp.pack_scalars(spec, scalars)
    assert np.array_equal(packed, rpp.pack_scalars(rspec, scalars))
    W = S.shape[1]
    # uint32 words reach the card as int32 bit patterns
    got = pp.unpack_limbs(torch.as_tensor(packed.view(np.int32)), W)
    assert np.array_equal(got.numpy(), S)
    assert np.array_equal(
        np.asarray(rpp.unpack_limbs(jnp.asarray(packed), W)), S)
    assert pp.scalars_to_limbs(spec, []).shape == (0, W)


def test_pad_inputs_matches_reference():
    spec, rspec = TC.bn254_g1, RC.bn254_g1
    dc, R = get_device_curve(spec, "cpu"), ref_curve(rspec)
    pts, r = _points(spec, 5, 34)
    P = dc.encode_points(pts)
    S = pp.scalars_to_limbs(spec, [r.randrange(spec.r) for _ in pts])
    got = pp._pad_inputs(dc, *P, torch.as_tensor(S), multiple=4)
    want = rpp._pad_inputs(
        R, *(jnp.asarray(a.numpy()) for a in P), jnp.asarray(S), multiple=4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
