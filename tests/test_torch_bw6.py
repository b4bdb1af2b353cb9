"""BW6-761's groups in davinci_tpu_torch, held against the JAX package and
host arithmetic on the CPU: G1 (b = -1) and G2 (the twist, b = 4) both
lie over the 761-bit Fp (L = 64), so both are `DeviceCurve`s over the
plain field at L = 64 and both take the scan path on the card.

* `DeviceCurve.add` (B1's plain version) equals the reference's add,
  limb for limb, on random points, the identity, doublings and P + (-P).
* The scan-path MSM (B1-B5's plain versions) equals a host oracle, with
  the windows shrunk to 4 bits as in tests/test_torch_msm_scan.py
  (scalars 0, 1 and r - 1, a run of equal scalars, an infinity base).
* The kernels' Consts carry G1's 3b = -3 as a negated small integer, the
  form B2's mixed add takes (3b = 12 on G2 stays positive).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch.ec import cuda_add, get_device_curve
from davinci_tpu_torch.kernels import KERNELS
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import pippenger as pp

torch.set_num_threads(1)

CURVES = ["bw6_g1", "bw6_g2"]


@pytest.fixture
def four_bit(monkeypatch):
    monkeypatch.setattr(pp, "COLS", 16)
    monkeypatch.setattr(bk, "REDUCE_C", 4)
    for mod in (pp, rpp):
        monkeypatch.setattr(mod, "WINDOW_BITS", 4)
        monkeypatch.setattr(mod, "NBUCKETS", 16)
        monkeypatch.setattr(mod, "SIGNED_NBUCKETS", 8)


def _points(spec, n, seed):
    r = random.Random(seed)
    return [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(n)], r


@pytest.mark.parametrize("name", CURVES)
def test_add_matches_reference(name):
    rspec, tspec = getattr(RC, name), getattr(TC, name)
    R, T = ref_curve(rspec), get_device_curve(tspec, "cpu")
    pts, _ = _points(tspec, 6, 41)
    P = T.encode_points(pts)
    ident = T.identity((2,))
    lhs = tuple(torch.cat([a, a[:2], a[:2], b]) for a, b in zip(P, ident))
    neg = T.neg(tuple(a[2:4] for a in P))
    rhs = tuple(torch.cat([torch.roll(a, 1, 0), a[:2], n, b])
                for a, n, b in zip(P, neg, ident))
    got = T.add(lhs, rhs)
    want = R.add(tuple(jnp.asarray(a.numpy()) for a in lhs),
                 tuple(jnp.asarray(a.numpy()) for a in rhs))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    host = [a.add(b) for a, b in zip(T.decode_points(lhs),
                                      T.decode_points(rhs))]
    assert T.decode_points(got) == host


@pytest.mark.parametrize("name", CURVES)
def test_scan_msm_matches_host(name, four_bit):
    spec = getattr(TC, name)
    dc = get_device_curve(spec, "cpu")
    pts, r = _points(spec, 20, 43)
    pts[5] = spec.infinity()
    scalars = [r.randrange(spec.r) for _ in pts]
    scalars[:3] = [0, 1, spec.r - 1]
    scalars[8:14] = [scalars[8]] * 6
    P = dc.encode_points(pts)
    S = torch.as_tensor(pp.scalars_to_limbs(spec, scalars))
    before = [k.launches for k in KERNELS]
    out = pp._msm_scan(dc, P, S)
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    want = spec.infinity()
    for p, s in zip(pts, scalars):
        want = want.add(p.mul(s))
    assert got == want
    assert [k.launches for k in KERNELS] == before  # plain versions


@pytest.mark.parametrize("name, small, neg", [("bw6_g1", 3, True),
                                              ("bw6_g2", 12, False),
                                              ("bn254_g1", 9, False)])
def test_consts_carry_the_sign_of_3b(name, small, neg):
    dc = get_device_curve(getattr(TC, name), "cpu")
    spec = dc.df.spec
    b3 = sum(int(v) << (12 * i) for i, v in enumerate(dc.b3.tolist()))
    assert cuda_add.b3_signed_small(spec.p, spec.num_limbs, b3) == (small,
                                                                     neg)
    consts = cuda_add._consts(dc)
    assert (consts[len(consts) - 2], consts[len(consts) - 1]) == (small,
                                                                  int(neg))
