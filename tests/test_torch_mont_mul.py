"""B6, the Montgomery product of davinci_tpu_torch (ff/cuda_mul.py and the
DeviceField products on it), held limb for limb against the JAX
package's DeviceField.mul on the CPU.

On CPU tensors `mont_mul` runs its plain version, the one the CUDA kernel
is held to on the card (tests/test_torch_cuda.py).  Inputs are made from
seeded numpy draws and cross as numpy arrays: random elements, 0, 1,
p - 1, and raw values up to R - 1 through `to_mont`.  The reference's
interpret-mode Pallas kernel is compared behind RUN_SLOW_TESTS.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import fields as RF
from davinci_tpu.ff import get_device_field as ref_field
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch import kernels as K
from davinci_tpu_torch.ff import cuda_mul, get_device_field

torch.set_num_threads(1)

# every field B6 is built for: L = 22 (p below 2^255), L = 32 and L = 64
# (BW6-761's Fp; test_torch_l64_field.py draws over all of its range)
SUPPORTED = ["bn254_fr", "bn254_fp", "bls12_377_fr", "bls12_381_fr",
             "bls12_377_fp", "bls12_381_fp", "bw6_761_fp"]
N = 61  # random draws per operand


def _limbs(vals, L):
    """Unreduced ints below 2^(12 L) -> (n, L) int32 12-bit limbs."""
    return np.array([[(v >> (12 * j)) & 0xFFF for j in range(L)]
                     for v in vals], np.int32)


def _draws(p, bound, seed):
    """N ints below `bound` from a seeded numpy generator, plus 0, 1 and
    p - 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(N, 12), dtype=np.uint64)
    vals = [sum(int(w) << (32 * k) for k, w in enumerate(row)) % bound
            for row in words]
    return vals + [0, 1, p - 1]


def _same(ref_arr, t):
    assert np.array_equal(np.asarray(ref_arr), t.numpy())


@pytest.mark.parametrize("name", SUPPORTED)
def test_plain_mont_mul_matches_reference(name):
    rspec, tspec = getattr(RF, name), getattr(TF, name)
    R, T = ref_field(rspec), get_device_field(tspec, "cpu")
    p, L = tspec.p, tspec.num_limbs
    assert K.B6.at(L) is not None
    xs, ys = _draws(p, p, 1), _draws(p, p, 2)
    raw = _draws(p, 1 << (12 * L), 3)
    raw[-1] = (1 << (12 * L)) - 1  # R - 1
    c = _limbs(raw, L)
    a_r, b_r = R.encode(xs), R.encode(ys)
    a_t, b_t = T.encode(xs), T.encode(ys)
    _same(a_r, a_t)
    want = R.mul(a_r, b_r)
    _same(want, cuda_mul.mont_mul_plain(T, a_t, b_t))
    _same(want, T.mul(a_t, b_t))
    _same(R.mul(a_r, b_r[:1]), T.mul(a_t, b_t[:1]))  # broadcast operand
    _same(R.to_mont(jnp.asarray(c)), T.to_mont(torch.as_tensor(c)))
    _same(R.from_mont(a_r), T.from_mont(a_t))
    _same(R.inv(a_r), T.inv(a_t))
    assert T.decode(T.mul(a_t, b_t)) == [x * y % p for x, y in zip(xs, ys)]
    assert T.decode(T.to_mont(torch.as_tensor(c))) == [v % p for v in raw]


def test_cpu_products_launch_no_kernel():
    T = get_device_field(TF.bn254_fr, "cpu")
    before = [k.launches for k in K.KERNELS]
    T.inv(T.encode([3, 5, 7]))
    assert [k.launches for k in K.KERNELS] == before


@pytest.mark.parametrize("name", ["secp256k1_fp", "secp256k1_fn"])
def test_unsupported_field_raises_on_the_card_path(name, monkeypatch):
    """A field no build of B6 serves (256-bit moduli at L = 22) raises at
    its first product on a CUDA device, before any launch: the wrapper's
    device check is made to report a card for these CPU tensors."""
    T = get_device_field(getattr(TF, name), "cpu")
    a = T.encode([1, 2])
    assert T.decode(T.mul(a, a)) == [1, 4]  # the CPU path serves it
    monkeypatch.setattr(cuda_mul, "check_tensors",
                        lambda kernel, ts: torch.device("cuda"))
    before = K.B6.launches
    with pytest.raises(ValueError, match="modulus"):
        T.mul(a, a)
    assert K.B6.launches == before


def test_no_build_for_other_limb_counts():
    # B6 is built at L = 22, 32 and 64 (BW6-761's Fp), not at 40
    assert K.B6.at(64) is K.B6_L64
    K.field_consts(K.B6, TF.bw6_761_fp)
    with pytest.raises(ValueError, match="L = 40"):
        K.field_consts(K.B6, TF.FieldSpec("l40", TF.BLS12_381_P, 40))
    # B7 is built at L = 22 and 32, B8 at L = 22 only
    assert K.B7.at(32) is K.B7_L32
    with pytest.raises(ValueError, match="L = 22 and 32 only, not L = 64"):
        K.B7.at(64)
    with pytest.raises(ValueError, match="L = 22 only, not L = 64"):
        K.B8["v2d"].at(64)
    with pytest.raises(ValueError, match="L = 22 only"):
        K.B8["v2d"].at(32)


@pytest.mark.parametrize("a_shape,b_shape", [
    ((6, 4), (6, 4)), ((6, 4), (4,)), ((6, 4), ()), ((1, 4), (6, 4)),
    ((6, 1), (6, 4)), ((2, 3, 4), (3, 4)), ((3, 1, 4), (1, 2, 4)),
])
def test_broadcast_rows(a_shape, b_shape):
    """The kernel's operand layout: element i of the broadcast batch reads
    row i % rows of each operand's `_rows` array."""
    L = 3
    a = torch.arange(int(np.prod(a_shape)) * L, dtype=torch.int32)
    b = -torch.arange(int(np.prod(b_shape)) * L, dtype=torch.int32)
    a, b = a.reshape(a_shape + (L,)), b.reshape(b_shape + (L,))
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = int(np.prod(shape))
    for x, want in zip((a, b), torch.broadcast_tensors(a, b)):
        rows = cuda_mul._rows(x, shape, L)
        assert rows.is_contiguous() and rows.shape[1] == L
        got = rows[torch.arange(n) % rows.shape[0]]
        assert torch.equal(got, want.reshape(-1, L))


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="interpret-mode Pallas kernels are slow; set RUN_SLOW_TESTS=1",
)
@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fp"])
def test_plain_mont_mul_matches_pallas_interpret(name):
    """One TILE_N tile of the reference's kernel in interpret mode, as its
    tests/test_pallas_kernels.py runs it."""
    from davinci_tpu.ff.pallas_mul import TILE_N, mont_mul

    rspec, tspec = getattr(RF, name), getattr(TF, name)
    R, T = ref_field(rspec), get_device_field(tspec, "cpu")
    p = tspec.p
    rng = np.random.default_rng(4)
    xs = [int(v) % p for v in rng.integers(0, 1 << 62, TILE_N - 3)] + [0, 1, p - 1]
    ys = list(reversed(xs))
    a_r, b_r = R.encode(xs), R.encode(ys)
    _same(mont_mul(R, a_r, b_r, interpret=True),
          cuda_mul.mont_mul_plain(T, T.encode(xs), T.encode(ys)))
