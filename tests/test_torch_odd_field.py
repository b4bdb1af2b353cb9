"""The plain `DeviceField` at odd limb counts, held against the JAX
package's `DeviceField` and against Python ints.

The toy BLS12 curve (`circuits/toycurve.py`) has a 58-bit Fr in L = 5
limbs and an 85-bit Fp in L = 8.  At odd L the port's wide limbs end in
one that holds 12 bits, and the Montgomery radix stays R = 2^(12 L), so
its limbs must equal the reference's exactly.  On a CUDA device an odd L
is refused: no kernel is built for it and nothing falls back to the
plain product (tests/test_torch_cuda.py holds that on the card).
"""

import numpy as np
import pytest
import torch

from davinci_tpu.circuits.toycurve import toy_bls12 as ref_toy_bls12
from davinci_tpu.ff.mod import DeviceField as RefDeviceField
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.circuits.toycurve import toy_bls12
from davinci_tpu_torch.ff.mod import DeviceField

torch.set_num_threads(1)

N = 24


def _values(p, rng, n=N):
    vals = [int.from_bytes(rng.bytes(16), "little") % p for _ in range(n - 3)]
    return vals + [0, 1, p - 1]


@pytest.fixture(scope="module", params=["fr_spec", "fp_spec"])
def pair(request):
    """(reference field, port field) of the toy curve's Fr (L = 5) or Fp
    (L = 8)."""
    ref_spec = ref_toy_bls12()[request.param]
    spec = toy_bls12()[request.param]
    assert (spec.p, spec.num_limbs) == (ref_spec.p, ref_spec.num_limbs)
    return RefDeviceField(ref_spec), DeviceField(spec, "cpu")


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_toy_limb_counts(pair):
    ref, port = pair
    assert port.L == ref.L and port.L in (5, 8)


def test_mul_and_montgomery_boundary(pair):
    ref, port = pair
    rng = np.random.default_rng(5)
    p = port.spec.p
    xs, ys = _values(p, rng), _values(p, rng)[::-1]
    # raw limbs of any value below R enter Montgomery form
    raw = [int.from_bytes(rng.bytes(16), "little") % (1 << 12 * port.L)
           for _ in range(N)]
    raw_limbs = port.spec.batch_to_limbs(raw)
    a, b = port.encode(xs), port.encode(ys)
    ra, rb = ref.encode(xs), ref.encode(ys)
    _same(a, ra)
    _same(port.to_mont(torch.as_tensor(raw_limbs)),
          ref.to_mont(np.asarray(raw_limbs)))
    _same(port.mul(a, b), ref.mul(ra, rb))
    _same(port.mul_plain(a, b), ref.mul(ra, rb))
    _same(port.from_mont(a), ref.from_mont(ra))
    assert port.decode(port.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]


def test_inv_and_pow_const(pair):
    ref, port = pair
    rng = np.random.default_rng(6)
    xs = _values(port.spec.p, rng)
    a, ra = port.encode(xs), ref.encode(xs)
    _same(port.inv(a), ref.inv(ra))
    _same(port.pow_const(a, 0x1234567), ref.pow_const(ra, 0x1234567))
    _same(port.pow_const(a, 0), ref.pow_const(ra, 0))


@pytest.mark.parametrize("p,L", [(TF.BN254_P, 23), (TF.BN254_P, 31),
                                 ((1 << 127) - 1, 11)],
                         ids=["bn254p-23", "bn254p-31", "m127-11"])
def test_other_odd_limb_counts_against_ints(p, L):
    """Every plain operation at odd L against Python ints, up to L = 31."""
    spec = TF.FieldSpec(f"odd_{L}", p, L)
    df = DeviceField(spec, "cpu")
    rng = np.random.default_rng(L)
    xs = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(N - 3)]
    xs += [0, 1, p - 1]
    ys = xs[::-1]
    a, b = df.encode(xs), df.encode(ys)
    R = 1 << (12 * L)
    assert spec.batch_from_limbs(a.numpy()) == [x * R % p for x in xs]
    assert df.decode(df.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert df.decode(df.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert df.decode(df.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert df.decode(df.neg(a)) == [-x % p for x in xs]
    assert df.decode(df.inv(a)) == [pow(x, p - 2, p) for x in xs]
    assert df.decode(df.pow_const(a, 65537)) == [pow(x, 65537, p) for x in xs]
    cond = torch.as_tensor([i % 2 == 0 for i in range(N)])
    assert df.decode(df.select(cond, a, b)) == [
        x if i % 2 == 0 else y for i, (x, y) in enumerate(zip(xs, ys))]


def test_odd_limb_count_is_refused_off_the_cpu():
    """No kernel is built for an odd L, so a field on the card raises at
    construction; an L above 64 (BW6-761's Fp, the largest served) raises
    anywhere."""
    with pytest.raises(ValueError):
        DeviceField(toy_bls12()["fr_spec"], "cuda")
    assert DeviceField(TF.bw6_761_fp, "cpu").L == 64
    with pytest.raises(ValueError):
        DeviceField(TF.FieldSpec("wide", TF.BW6_761_P, 66), "cpu")

