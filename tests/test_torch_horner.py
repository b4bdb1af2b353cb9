"""The window combine (Horner) of davinci_tpu_torch's MSMs on the CPU:
the plain version of B5's G2 build (`bucket_kernel.horner_g2_kernel`)
held limb for limb against the JAX package's `pippenger._horner` on
BN254 and BLS12-377 G2, `pippenger._horner`'s routes through the
wrappers, and the constant the six-thread G1 mixed add of
csrc/group6.cuh takes for 3b.  The reference's `_horner` compiles once
per curve (its loops are `fori_loop`s), whatever W and B are.
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
from davinci_tpu_torch import kernels as K
from davinci_tpu_torch.ec import cuda_add, get_device_curve
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import pippenger as pp

torch.set_num_threads(1)


def _window_sums(tspec, T, W, B, seed):
    """(W, B, ...) x3 projective sums (Z != 1) of points k G with random
    64-bit k (cheap host scalar muls), with window 1 of batch 0 the
    identity."""
    rng = random.Random(seed)
    n = W * B
    pts = T.encode_points([tspec.gen.mul(rng.randrange(1, 1 << 64))
                           for _ in range(2 * n)])
    P = cuda_add.rcb15_plain(T, tuple(a[:n] for a in pts),
                             tuple(a[n:] for a in pts))
    ident = T.identity(())
    P = tuple(a.reshape((W, B) + T._eshape).clone() for a in P)
    for a, i in zip(P, ident):
        a[1, 0] = i
    return P


@pytest.mark.parametrize("name", ["bn254_g2", "bls377_g2"])
def test_plain_g2_horner_matches_reference(name):
    """B5's G2 plain version, and `_horner`'s route to it, equal the
    reference's `_horner` limb for limb (W = 3, one batch column)."""
    tspec, rspec = getattr(TC, name), getattr(RC, name)
    T, R = get_device_curve(tspec, "cpu"), ref_curve(rspec)
    W = 3
    sums = _window_sums(tspec, T, W, 1, 1)
    got = bk.horner_g2_kernel(T, sums, pp.WINDOW_BITS)
    want = rpp._horner(R, tuple(jnp.asarray(a.numpy()) for a in sums), W)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(pp._horner(T, sums, W), got):
        assert torch.equal(a, b)


def test_g1_horner_route_matches_b5_plain():
    """`_horner` on G1 rows equals B5's plain version on the transposed
    sums: the route it takes, here to the plain version."""
    T = get_device_curve(TC.bn254_g1, "cpu")
    W = 4
    sums = tuple(a[:, 0] for a in _window_sums(TC.bn254_g1, T, W, 1, 2))
    want = bk._horner_plain(T, tuple(s.T.contiguous() for s in sums), W,
                            pp.WINDOW_BITS)
    for a, b in zip(pp._horner(T, sums, W), want):
        assert torch.equal(a, b[:, 0])



@pytest.mark.parametrize("name", ["bn254_g1", "bn254_g2"])
def test_horner_over_batch_dims(name):
    """`_horner` on (W, B, ...) sums equals `_horner` on each batch column
    alone: its batch axes fold into the wrappers' columns and back."""
    spec = getattr(TC, name)
    T = get_device_curve(spec, "cpu")
    W, B = 2, 3
    sums = _window_sums(spec, T, W, B, 3)
    got = pp._horner(T, sums, W)
    for b in range(B):
        for a, c in zip(got, pp._horner(T, tuple(s[:, b] for s in sums), W)):
            assert torch.equal(a[b], c)


def test_g2_horner_wrapper_refuses():
    T2 = get_device_curve(TC.bn254_g2, "cpu")
    T1 = get_device_curve(TC.bn254_g1, "cpu")
    g1_rows = tuple(torch.zeros((3, 1, 22), dtype=torch.int32)
                    for _ in range(3))
    with pytest.raises(ValueError):
        bk.horner_g2_kernel(T2, g1_rows, pp.WINDOW_BITS)
    meta = tuple(torch.zeros((3, 1, 2, 22), dtype=torch.int32, device="meta")
                 for _ in range(3))
    with pytest.raises(ValueError):
        bk.horner_g2_kernel(T2, meta, pp.WINDOW_BITS)
    with pytest.raises(ValueError):  # a G1 curve has no G2 build's consts
        bk._cuda_curve(K.B5G2, T1, g1_rows, coord_ndim=2)


@pytest.mark.parametrize("name, want", [
    ("bn254_g1", 9), ("bls377_g1", 3), ("bls381_g1", 12)])
def test_b3_small_is_three_b(name, want):
    """The Consts words that let the six-thread G1 mixed add multiply by
    3b with additions: 3b itself, the second-to-last word of the array,
    and its sign, the last (0 here: BW6-761's G1 sets it, 3b = -3,
    test_torch_bw6.py)."""
    T = get_device_curve(getattr(TC, name), "cpu")
    consts = cuda_add._consts(T)
    assert (consts[len(consts) - 2], consts[len(consts) - 1]) == (want, 0)
    p, L = T.df.spec.p, T.df.L
    assert cuda_add.b3_small(p, L, want * (1 << (12 * L)) % p) == want
    big = cuda_add.B3_SMALL_MAX * (1 << (12 * L)) % p
    assert cuda_add.b3_small(p, L, big) == 0
