"""davinci_tpu_torch device witness reduction (groth16/witness_dev.py)
held against the host numpy-object matvec (`r1cs.matvec_flat`) and the
JAX package's `matvec_device`, on the CPU."""

import random

import numpy as np
import torch

import jax.numpy as jnp

from davinci_tpu import fields as RF
from davinci_tpu.groth16 import witness_dev as ref_wd
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu.ntt import get_device_ntt as ref_ntt
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.groth16 import ConstraintSystem
from davinci_tpu_torch.groth16.r1cs import matvec_flat
from davinci_tpu_torch.groth16.witness_dev import (
    DeviceCSR,
    matvec_device,
    satisfied_device,
)
from davinci_tpu_torch.msm.pippenger import pack_scalars, unpack_limbs
from davinci_tpu_torch.ntt import get_device_ntt

torch.set_num_threads(1)

R = TF.BN254_R
W = -(-R.bit_length() // 12)


def _circuit(seed=7, depth=24):
    """Large and small coefficients, multi-term linear combinations, and
    a public output (the circuit of test_witness_dev.py)."""
    r = random.Random(seed)
    cs = ConstraintSystem(R)
    y = cs.pub_input(0)
    acc = cs.priv_input(r.randrange(1, R))
    for i in range(depth):
        k = r.randrange(1, R) if i % 3 == 0 else r.randrange(1, 9)
        acc = cs.mul(acc * k + i, acc + (R - 1))
    cs.values[1] = acc.value
    cs.assert_eq(acc, y)
    return cs


def _limbs(z):
    packed = pack_scalars(TC.bn254_g1, z).view(np.int32)
    return unpack_limbs(torch.as_tensor(packed), W)


def test_matvec_device_matches_host_and_reference():
    cs = _circuit()
    df = get_device_ntt(TF.bn254_fr, "cpu").df
    n = len(cs.constraints)
    N = 1 << max(1, (n - 1).bit_length())
    z = cs.witness()
    mats = cs._flat_matrices()
    dcsr = DeviceCSR(mats, R, df.L, "cpu")
    got = matvec_device(df, dcsr, _limbs(z), N)
    for g, w in zip(got, matvec_flat(mats, R, n, z, N)):
        assert df.decode(g) == w
    assert bool(satisfied_device(df, *got, n))

    rdf = ref_ntt(RF.bn254_fr).df
    Zr = rpp.unpack_limbs(jnp.asarray(pack_scalars(TC.bn254_g1, z)), W)
    want = ref_wd.matvec_device(rdf, ref_wd.DeviceCSR(mats, R, rdf.L), Zr, N)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_corrupted_witness_fails_the_device_check():
    cs = _circuit(seed=8, depth=6)
    df = get_device_ntt(TF.bn254_fr, "cpu").df
    n = len(cs.constraints)
    N = 1 << max(1, (n - 1).bit_length())
    z = list(cs.witness())
    z[2] = (z[2] + 1) % R
    dcsr = DeviceCSR(cs._flat_matrices(), R, df.L, "cpu")
    assert not bool(satisfied_device(df, *matvec_device(df, dcsr, _limbs(z), N), n))
