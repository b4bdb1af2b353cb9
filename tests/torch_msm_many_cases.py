"""Shared cases of the `msm_many` tests (tests/test_torch_cells.py,
test_torch_msm_many.py and test_torch_msm_many_bn254.py): M = 3 MSMs of
n = 24 points, one at infinity, with scalars 0, 1, r - 1 and a run of
equal scalars in each row, made from a seed; the reference's `msm_many`
and the host sums of the same inputs, computed once a curve.

`check_plain_route` holds the route CPU tensors take (one plain MSM per
m) to the reference's CPU route, limb for limb; `check_scan_route` the
card's route with the kernels' plain versions (`_use_pipeline` forced,
the scan width shrunk to 16 and the reduce's C to 32 as
tests/test_torch_msm_scan.py does) to the reference's points.  Both to
the host sums.  Tolerance: exact equality of limbs and points.
"""

import functools
import random

import numpy as np
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.msm import msm_host_input as ref_msm_host_input
from davinci_tpu.msm import msm_many as ref_msm_many
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.kernels import KERNELS
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import msm_host_input, msm_many
from davinci_tpu_torch.msm import pippenger as pp

M, N = 3, 24


def coords(pt):
    return None if pt.infinity else (pt.x.v, pt.y.v)


def host_msm(spec, pts, scalars):
    acc = spec.infinity()
    for p, s in zip(pts, scalars):
        acc = acc.add(p.mul(s))
    return acc


@functools.cache
def case(name, seed=5):
    """(spec, points, scalar rows, (M, N, W) limbs, the reference's
    msm_many as numpy limbs, the host sums) for curve `name`."""
    spec = getattr(TC, name)
    r = random.Random(seed)
    pts = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(N)]
    pts[5] = spec.infinity()
    rows = []
    for m in range(M):
        s = [r.randrange(spec.r) for _ in range(N)]
        s[m:m + 3] = [0, 1, spec.r - 1]
        s[10:16] = [s[10]] * 6
        rows.append(s)
    S = np.stack([pp.scalars_to_limbs(spec, s) for s in rows])
    P = get_device_curve(spec, "cpu").encode_points(pts)
    want = ref_msm_many(ref_curve(getattr(RC, name)),
                        tuple(jnp.asarray(a.numpy()) for a in P),
                        jnp.asarray(S))
    return (spec, pts, rows, S, tuple(np.asarray(a) for a in want),
            [host_msm(spec, pts, s) for s in rows])


def _encoded(name):
    spec, pts, rows, S, want, hosts = case(name)
    dc = get_device_curve(spec, "cpu")
    return dc, dc.encode_points(pts), torch.as_tensor(S), want, hosts


def check_plain_route(name):
    """CPU tensors: one plain MSM per m, limb-equal to the reference's
    CPU route (its `msm` per m), each the host sum."""
    dc, P, S, want, hosts = _encoded(name)
    got = msm_many(dc, P, S)
    assert got[0].shape == (M, dc.df.L)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert dc.decode_points(got) == hosts


def check_scan_route(name, monkeypatch):
    """The card's route with the kernels' plain versions and the setup's
    packed planes: signed recode of each scalar, M*W window rows through
    the scan path's window sums, the batch-major to window-major reorder
    and one Horner of all M.  Every MSM equals the reference's and the
    host's points, and no kernel launch is counted."""
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: True)
    monkeypatch.setattr(pp, "COLS", 16)
    monkeypatch.setattr(bk, "REDUCE_C", 32)
    dc, P, S, want, hosts = _encoded(name)
    horner = []
    real = pp._horner_dispatch
    monkeypatch.setattr(pp, "_horner_dispatch",
                        lambda c, s, W: horner.append(s[0].shape)
                        or real(c, s, W))
    before = [k.launches for k in KERNELS]
    got = msm_many(dc, P, S, precomp=bk.pack_points(dc, *P))
    assert [k.launches for k in KERNELS] == before
    assert horner == [(dc.df.L, S.shape[2] * M)]  # one combine of all M
    R_ = ref_curve(getattr(RC, name))
    ref_pts = R_.decode_points(tuple(jnp.asarray(a) for a in want))
    got_pts = dc.decode_points(got)
    assert [coords(p) for p in got_pts] == [coords(p) for p in ref_pts]
    assert got_pts == hosts


def check_host_input(name):
    spec, pts, rows, _, _, hosts = case(name)
    dc = get_device_curve(spec, "cpu")
    got = msm_host_input(dc, pts, rows[0])
    want = ref_msm_host_input(ref_curve(getattr(RC, name)), pts, rows[0])
    assert coords(got) == coords(want)
    assert got == hosts[0]
