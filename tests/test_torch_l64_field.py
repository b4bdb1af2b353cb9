"""The plain DeviceField of davinci_tpu_torch at L = 64 (BW6-761's Fp,
R = 2^768), held limb for limb against the JAX package's DeviceField on
the CPU.

Beyond 16 wide limbs a float64 column of 24-bit products could pass 2^53,
so the port sums the product columns in int64 there (`ff/mod.py`,
`conv_cols_int`): a small batch through one skewed outer product, a
large one through a multiply-add per limb.  Both are held here, and the
carry lookahead over more than 61 positions (blocks of 61).  Inputs are
made from a numpy seed over the whole range [0, p), plus 0, 1 and p - 1,
and cross as numpy arrays; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import fields as RF
from davinci_tpu.ff import get_device_field as ref_field
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.ff import get_device_field
from davinci_tpu_torch.ff import mod

torch.set_num_threads(1)

RSPEC, TSPEC = RF.bw6_761_fp, TF.bw6_761_fp
P, L = TSPEC.p, 64


def _ints(n, bound, seed):
    """n ints below `bound` from 24 seeded 32-bit words each, plus 0, 1
    and p - 1."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, 24), dtype=np.uint64)
    vals = [sum(int(w) << (32 * k) for k, w in enumerate(row)) % bound
            for row in words]
    return vals + [0, 1, P - 1]


def _same(ref_arr, t):
    assert np.array_equal(np.asarray(ref_arr), t.numpy())


@pytest.fixture(scope="module")
def fields():
    return ref_field(RSPEC), get_device_field(TSPEC, "cpu")


@pytest.mark.parametrize("n", [13, 509])  # the skewed and the looped sums
def test_l64_field_ops_match_reference(fields, n):
    R, T = fields
    xs, ys = _ints(n, P, 1), _ints(n, P, 2)
    a_r, b_r = R.encode(xs), R.encode(ys)
    a_t, b_t = T.encode(xs), T.encode(ys)
    _same(a_r, a_t)
    for op in ("mul", "add", "sub"):
        _same(getattr(R, op)(a_r, b_r), getattr(T, op)(a_t, b_t))
    for op in ("neg", "square", "from_mont"):
        _same(getattr(R, op)(a_r), getattr(T, op)(a_t))
    _same(R.mul(a_r, b_r[:1]), T.mul(a_t, b_t[:1]))  # broadcast operand
    cond = np.arange(len(xs)) % 3 == 0
    _same(R.select(jnp.asarray(cond), a_r, b_r),
          T.select(torch.as_tensor(cond), a_t, b_t))
    assert T.decode(T.mul(a_t, b_t)) == [x * y % P for x, y in zip(xs, ys)]


def test_l64_raw_values_enter_montgomery_form(fields):
    """to_mont of raw values up to R - 1 = 2^768 - 1, p and 0."""
    R, T = fields
    raw = _ints(29, 1 << (12 * L), 3) + [(1 << (12 * L)) - 1, P]
    c = np.array([[(v >> (12 * j)) & 0xFFF for j in range(L)] for v in raw],
                 np.int32)
    _same(R.to_mont(jnp.asarray(c)), T.to_mont(torch.as_tensor(c)))
    assert T.decode(T.to_mont(torch.as_tensor(c))) == [v % P for v in raw]


def test_l64_inv_and_pow_const_match_reference(fields):
    R, T = fields
    xs = _ints(5, P, 4)
    a_r, a_t = R.encode(xs), T.encode(xs)
    _same(R.inv(a_r), T.inv(a_t))
    _same(R.pow_const(a_r, 65537), T.pow_const(a_t, 65537))
    _same(R.pow_const(a_r, 0), T.pow_const(a_t, 0))
    assert T.decode(T.inv(a_t)) == [pow(x, -1, P) if x else 0 for x in xs]


def test_int64_columns_take_both_routes_alike():
    """`conv_cols_int`'s skewed outer product and its looped sum give the
    same columns, at the bound of the limbs the REDC feeds it (2^24 +
    2^23), and the blocked carry lookahead equals a ripple."""
    rng = np.random.default_rng(5)
    top = (1 << 24) + (1 << 23)
    for n in (3, mod._INT_COLS_SMALL + 1):
        a = torch.as_tensor(rng.integers(0, top, size=(n, 32)))
        b = torch.as_tensor(rng.integers(0, top, size=(n, 32)))
        got = mod.conv_cols_int(a, b)
        want = torch.zeros((n, 64), dtype=torch.int64)
        for i in range(32):
            want[:, i:i + 32] += a[:, i:i + 1] * b
        assert torch.equal(got, want)
    x = torch.as_tensor(rng.integers(0, (1 << 25) - 1, size=(7, 130)))
    carry, ripple = torch.zeros(7, dtype=torch.int64), []
    for i in range(130):
        v = x[:, i] + carry
        ripple.append(v & ((1 << 24) - 1))
        carry = v >> 24
    assert torch.equal(mod.normalize(x, 24, 25), torch.stack(ripple, -1))
