"""davinci_tpu_torch field layer (ff/mod.py DeviceField, ff/quad.py
DeviceQuadExt) held limb for limb against the JAX package on the CPU.

Inputs are made from seeds on the host and go through both packages as
numpy arrays; every comparison is exact."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import fields as RF
from davinci_tpu.ff import get_device_field as ref_field
from davinci_tpu.ff.mod import carry_fix as ref_carry_fix
from davinci_tpu.ff.quad import get_device_quad as ref_quad
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.ff import get_device_field
from davinci_tpu_torch.ff.mod import carry_fix
from davinci_tpu_torch.ff.quad import get_device_quad

torch.set_num_threads(1)

BN254 = ["bn254_fr", "bn254_fp"]
# every registered field (bw6_761_fp's 64 limbs take the int64 columns)
EVEN = ["bn254_fr", "bn254_fp", "bls12_377_fr", "bls12_377_fp",
        "bls12_381_fr", "bls12_381_fp", "secp256k1_fp", "secp256k1_fn",
        "bw6_761_fp"]


def _elems(p, n, seed):
    r = random.Random(seed + p % 100003)
    return [r.randrange(p) for _ in range(n - 3)] + [0, 1, p - 1]


def _pair(name):
    return getattr(RF, name), getattr(TF, name)


def _same(ref_arr, t):
    assert np.array_equal(np.asarray(ref_arr), t.numpy())


@pytest.mark.parametrize("name", BN254)
def test_field_ops_match_reference(name):
    rspec, tspec = _pair(name)
    R, T = ref_field(rspec), get_device_field(tspec, "cpu")
    xs = _elems(rspec.p, 24, 1)
    ys = _elems(rspec.p, 24, 2)
    a_r, b_r = R.encode(xs), R.encode(ys)
    a_t, b_t = T.encode(xs), T.encode(ys)
    _same(a_r, a_t)
    for op in ("mul", "add", "sub"):
        _same(getattr(R, op)(a_r, b_r), getattr(T, op)(a_t, b_t))
    for op in ("neg", "double", "square", "inv", "from_mont"):
        _same(getattr(R, op)(a_r), getattr(T, op)(a_t))
    _same(R.pow_const(a_r, 5), T.pow_const(a_t, 5))
    _same(R.pow_const(a_r, 0), T.pow_const(a_t, 0))
    _same(R.to_mont(R.encode_raw(xs)), T.to_mont(T.encode_raw(xs)))
    _same(R.encode_scalar(xs[0]), T.encode_scalar(xs[0]))
    cond = np.arange(len(xs)) % 3 == 0
    _same(R.select(jnp.asarray(cond), a_r, b_r),
          T.select(torch.as_tensor(cond), a_t, b_t))
    _same(R.is_zero(a_r), T.is_zero(a_t))
    _same(R.eq(a_r, a_r), T.eq(a_t, a_t))
    assert T.decode(a_t) == xs


@pytest.mark.parametrize("name", BN254)
def test_broadcast_and_batch_dims(name):
    rspec, tspec = _pair(name)
    R, T = ref_field(rspec), get_device_field(tspec, "cpu")
    xs = _elems(rspec.p, 12, 3)
    a_r = R.encode(xs).reshape(3, 4, -1)
    a_t = T.encode(xs).reshape(3, 4, -1)
    _same(R.mul(a_r, R.one_mont), T.mul(a_t, T.one_mont))
    _same(R.mul(a_r, a_r[:1]), T.mul(a_t, a_t[:1]))


@pytest.mark.parametrize("name", EVEN)
def test_field_ops_match_python_ints(name):
    spec = getattr(TF, name)
    T = get_device_field(spec, "cpu")
    p = spec.p
    xs, ys = _elems(p, 16, 4), _elems(p, 16, 5)
    a, b = T.encode(xs), T.encode(ys)
    assert T.decode(T.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert T.decode(T.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert T.decode(T.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert T.decode(T.neg(a)) == [-x % p for x in xs]
    assert T.decode(T.inv(a)) == [pow(x, -1, p) if x else 0 for x in xs]


def test_carry_fix_matches_reference():
    """Signed column sums (borrows included) normalise to the same limbs,
    carries past n_out dropped, as in the reference."""
    rng = np.random.default_rng(7)
    cols = rng.integers(-(1 << 29), 1 << 29, size=(64, 22), dtype=np.int64)
    cols[:, -1] = np.abs(cols[:, -1])  # a non-negative total
    cols = cols.astype(np.int32)
    for n_out in (22, 23, 30):
        _same(ref_carry_fix(jnp.asarray(cols), n_out),
              carry_fix(torch.as_tensor(cols), n_out))


def test_wide_limb_field_rejects_more_than_32_limbs():
    """Up to 64 limbs since BW6-761's Fp is served (test_torch_l64_field.py);
    a count above 64 is still refused."""
    assert get_device_field(TF.bw6_761_fp, "cpu").L == 64
    with pytest.raises(ValueError):
        get_device_field(TF.FieldSpec("wide", TF.BW6_761_P, 66), "cpu")


def test_quad_ext_matches_reference():
    rspec, tspec = _pair("bn254_fp")
    R, T = ref_quad(rspec, -1), get_device_quad(tspec, -1, "cpu")
    p = rspec.p
    xs = list(zip(_elems(p, 12, 6), _elems(p, 12, 7)))
    ys = list(zip(_elems(p, 12, 8), _elems(p, 12, 9)))
    xs.append((0, 0))
    ys.append((1, 0))
    a_r, b_r = R.encode(xs), R.encode(ys)
    a_t, b_t = T.encode(xs), T.encode(ys)
    _same(a_r, a_t)
    for op in ("mul", "add", "sub"):
        _same(getattr(R, op)(a_r, b_r), getattr(T, op)(a_t, b_t))
    for op in ("neg", "double", "square", "inv"):
        _same(getattr(R, op)(a_r), getattr(T, op)(a_t))
    _same(R.is_zero(a_r), T.is_zero(a_t))
    assert T.decode(a_t) == xs
