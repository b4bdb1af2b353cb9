"""davinci_tpu_torch NTT (ntt/ntt.py DeviceNTT) held limb for limb against
the JAX package's DeviceNTT on the CPU, at a 2^6 domain."""

import random

import numpy as np
import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.ntt import get_device_ntt as ref_ntt
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.ntt import get_device_ntt

torch.set_num_threads(1)


def _pair(n, batch=()):
    R, T = ref_ntt(RF.bn254_fr), get_device_ntt(TF.bn254_fr, "cpu")
    r = random.Random(n + len(batch))
    vals = [r.randrange(RF.bn254_fr.p) for _ in range(n * int(np.prod(batch)))]
    shape = batch + (n, -1)
    return R, T, R.df.encode(vals).reshape(shape), T.df.encode(vals).reshape(shape)


def _same(a, b):
    assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("op", ["ntt", "intt", "coset_ntt", "coset_intt"])
@pytest.mark.parametrize("batch", [(), (2,)], ids=["flat", "batched"])
def test_transforms_match_reference(op, batch):
    R, T, x_r, x_t = _pair(64, batch)
    _same(getattr(R, op)(x_r), getattr(T, op)(x_t))


def test_explicit_root_and_power_table_match_reference():
    R, T, x_r, x_t = _pair(64)
    p = RF.bn254_fr.p
    w = pow(7, (p - 1) // 64, p)
    _same(R.ntt_with_root(x_r, w), T.ntt_with_root(x_t, w))
    _same(R.intt_with_root(x_r, w), T.intt_with_root(x_t, w))
    _same(R.power_table(5, 13), T.power_table(5, 13))


def test_roundtrips():
    _, T, _, x = _pair(64)
    assert torch.equal(T.intt(T.ntt(x)), x)
    assert torch.equal(T.coset_intt(T.coset_ntt(x)), x)
    _, T, _, one = _pair(1)
    assert torch.equal(T.ntt(one), one)
    with pytest.raises(ValueError):
        T.ntt(torch.zeros((3, T.df.L), dtype=torch.int32))
