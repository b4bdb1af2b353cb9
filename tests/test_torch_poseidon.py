"""The batched device Poseidon of davinci_tpu_torch (`DevicePoseidon`,
`get_device_poseidon`) held against the JAX package's on the CPU.

On CPU tensors every field product runs B6's plain version, so these pin
what the card computes: hashes equal to the reference's device hash and
to the host `poseidon_hash` on the rows of tests/test_poseidon.py, the
permutation limb for limb (the partial rounds raise element 0 alone to
the fifth power, the reference all of them), and the bounded sum's
reduction on values near p.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davinci_tpu.hash import get_device_poseidon as ref_poseidon
from davinci_tpu_torch import fields as F
from davinci_tpu_torch.hash import (
    DevicePoseidon,
    get_device_poseidon,
    poseidon_hash,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("arity", [1, 2, 4, 16])
def test_hash_ints_matches_reference_and_host(arity):
    r = random.Random(arity)  # tests/test_poseidon.py's rows
    rows = [[r.randrange(F.BN254_R) for _ in range(arity)] for _ in range(5)]
    got = get_device_poseidon(arity + 1, device="cpu").hash_ints(rows)
    assert got == [poseidon_hash(row) for row in rows]
    assert got == ref_poseidon(arity + 1).hash_ints(rows)


def _mont_state(dp, shape, seed):
    """Random Montgomery limbs (*shape, t, L) below p, some of them p - 1."""
    rng = random.Random(seed)
    n = int(np.prod(shape)) * dp.t
    vals = [rng.randrange(F.BN254_R) for _ in range(n)]
    vals[::7] = [F.BN254_R - 1] * len(vals[::7])
    mont = [v * F.bn254_fr.r % F.BN254_R for v in vals]
    return F.bn254_fr.batch_to_limbs(mont).reshape(shape + (dp.t, dp.df.L))


@pytest.mark.parametrize("t", [3, 17])
def test_permute_matches_reference_limbs(t):
    dp = get_device_poseidon(t, device="cpu")
    state = _mont_state(dp, (2, 3), t)
    got = dp.permute(torch.as_tensor(state))
    want = ref_poseidon(t).permute(jnp.asarray(state))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sum_mod_near_p_matches_reference():
    """17 terms (the widest mix), each p - 1 - i or random, reduced mod p
    limb for limb as the reference reduces them."""
    dp = get_device_poseidon(17, device="cpu")
    rng = random.Random(17)
    p, r = F.BN254_R, F.bn254_fr.r
    rows = [[p - 1 - i for i in range(17)],
            [p - 1] * 17,
            [rng.randrange(p) for _ in range(17)],
            [0] * 16 + [p - 1]]
    terms = F.bn254_fr.batch_to_limbs(
        [v * r % p for row in rows for v in row]).reshape(4, 17, dp.df.L)
    got = dp._sum_mod(torch.as_tensor(terms))
    want = ref_poseidon(17)._sum_mod(jnp.asarray(terms))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert dp.df.decode(got) == [sum(row) % p for row in rows]


def test_device_poseidon_is_cached_per_device():
    dp = get_device_poseidon(3, device="cpu")
    assert dp is get_device_poseidon(3, F.bn254_fr, torch.device("cpu"))
    assert dp.device == torch.device("cpu") and dp.C.device.type == "cpu"
    assert isinstance(dp, DevicePoseidon)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            get_device_poseidon(3)
