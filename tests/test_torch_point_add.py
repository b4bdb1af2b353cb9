"""davinci_tpu_torch point arithmetic (ec/weier.py DeviceCurve and the
plain version of kernels B1/B7 in ec/cuda_add.py) held limb for limb
against the JAX package's DeviceCurve on the CPU.

RCB15 outputs are canonical limbs in both packages, so projective results
compare exactly, not only after decoding.  The interpret-mode Pallas
kernels are compared behind RUN_SLOW_TESTS, as in test_pallas_kernels.py.
"""

import os
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.kernels import KERNELS
from davinci_tpu_torch.msm.pippenger import scalars_to_limbs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# BLS12-377's Fp2 has u^2 = -5 (the kernels' nr != -1 branch), BLS12-381's
# u^2 = -1; both at L = 32
CURVES = ["bn254_g1", "bn254_g2", "bls377_g2", "bls381_g2"]
# one batch shape for every case: the reference jit-compiles per shape
N = 4


def _curves(name):
    rspec, tspec = getattr(RC, name), getattr(TC, name)
    return rspec, tspec, ref_curve(rspec), get_device_curve(tspec, "cpu")


def _same(ref_pt, t_pt):
    for a, b in zip(ref_pt, t_pt):
        assert np.array_equal(np.asarray(a), b.numpy())


def _operands(rspec, tspec, R, T, n, seed):
    """n random pairs (P, Q) plus the edge cases O+P, P+O, P+P, P+(-P),
    O+O, and the same random pairs again in projective form (random Z),
    encoded in both packages."""
    rng = random.Random(seed)
    ks = [rng.randrange(1, rspec.r) for _ in range(2 * n)]
    hr = [rspec.gen.mul(k) for k in ks]
    ht = [tspec.gen.mul(k) for k in ks]
    Pr, Qr = R.encode_points(hr[:n]), R.encode_points(hr[n:])
    Pt, Qt = T.encode_points(ht[:n]), T.encode_points(ht[n:])
    Ir, It = R.identity((n,)), T.identity((n,))
    lhs_r = (Pr, Ir, Pr, Pr, Pr, Ir)
    rhs_r = (Qr, Pr, Ir, Pr, R.neg(Pr), Ir)
    lhs_t = (Pt, It, Pt, Pt, Pt, It)
    rhs_t = (Qt, Pt, It, Pt, T.neg(Pt), It)
    cat_r = lambda pts: tuple(jnp.concatenate([p[c] for p in pts]) for c in range(3))
    cat_t = lambda pts: tuple(torch.cat([p[c] for p in pts]) for c in range(3))
    A_r, B_r, A_t, B_t = cat_r(lhs_r), cat_r(rhs_r), cat_t(lhs_t), cat_t(rhs_t)
    # projective inputs: P+Q and Q+Q have Z != 1
    A_r = tuple(jnp.concatenate([a, b]) for a, b in zip(A_r, R.add(Pr, Qr)))
    B_r = tuple(jnp.concatenate([a, b]) for a, b in zip(B_r, R.add(Qr, Qr)))
    A_t = tuple(torch.cat([a, b]) for a, b in zip(A_t, T.add(Pt, Qt)))
    B_t = tuple(torch.cat([a, b]) for a, b in zip(B_t, T.add(Qt, Qt)))
    return A_r, B_r, A_t, B_t, ht


@pytest.mark.parametrize("name", CURVES)
def test_plain_add_matches_reference(name):
    rspec, tspec, R, T = _curves(name)
    A_r, B_r, A_t, B_t, _ = _operands(rspec, tspec, R, T, N, 11)
    before = [k.launches for k in KERNELS]
    _same(R.add(A_r, B_r), T.add(A_t, B_t))
    _same(R.double(A_r), T.double(A_t))
    # CPU tensors take the plain version: no kernel launch is counted
    assert [k.launches for k in KERNELS] == before


@pytest.mark.parametrize("name", CURVES)
def test_add_decodes_to_host_sum(name):
    rspec, tspec, R, T = _curves(name)
    n = N
    _, _, A_t, B_t, hpts = _operands(rspec, tspec, R, T, n, 12)
    got = T.decode_points(T.add(A_t, B_t))
    P, Q = hpts[:n], hpts[n:]
    want = ([p.add(q) for p, q in zip(P, Q)] + P + P + [p.double() for p in P]
            + [tspec.infinity()] * (2 * n)
            + [p.add(q).add(q.double()) for p, q in zip(P, Q)])
    assert got == want


@pytest.mark.parametrize("name", CURVES)
def test_point_ops_match_reference(name):
    rspec, tspec, R, T = _curves(name)
    A_r, B_r, A_t, B_t, _ = _operands(rspec, tspec, R, T, N, 13)
    _same(R.neg(A_r), T.neg(A_t))
    cond = np.arange(A_r[0].shape[0]) % 2 == 0
    _same(R.select(jnp.asarray(cond), A_r, B_r),
          T.select(torch.as_tensor(cond), A_t, B_t))
    _same(R.to_affine(A_r), T.to_affine(A_t))
    _same(R.affine_encoding(A_r), T.affine_encoding(A_t))
    _same(R.identity((2,)), T.identity((2,)))


@pytest.mark.parametrize("name", CURVES[:2])
def test_scalar_mul_matches_reference(name):
    rspec, tspec, R, T = _curves(name)
    rng = random.Random(14)
    pts = [tspec.gen.mul(rng.randrange(1, tspec.r)) for _ in range(2)]
    # the full width on G1; G2 scalars below 2^24 keep the case quick
    top = tspec.r if name == "bn254_g1" else 1 << 24
    scalars = [0, 1, top - 1, rng.randrange(top)]
    nbits = (top - 1).bit_length()
    P = T.encode_points(pts + pts)
    S = scalars_to_limbs(tspec, scalars)
    Pr = tuple(jnp.asarray(a.numpy()) for a in P)
    _same(R.scalar_mul(Pr, jnp.asarray(S), 20),
          T.scalar_mul(P, torch.as_tensor(S), 20))
    got = T.decode_points(T.scalar_mul(P, torch.as_tensor(S), nbits))
    assert got == [p.mul(s) for p, s in zip(pts + pts, scalars)]


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Where the CUDA toolkit is missing the build raises (a CUDA tensor
    then gets an error, never the plain version)."""
    from davinci_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_all()


def test_wrapper_rejects_other_devices():
    T = get_device_curve(TC.bn254_g1, "cpu")
    P = tuple(a.to("meta") for a in T.identity((2,)))
    with pytest.raises(ValueError):
        T.add(P, P)


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_kernel_records_name_their_sources(kernel):
    """`replaces` points at the Pallas kernel's definition, and the CUDA
    source exports the wrapper's symbol."""
    path, line = kernel.replaces.split(":")
    text = (REPO / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def _((point_add2?|scan|reduce|suffix_reduce|horner"
                    r"|mont_mul)_kernel|add_2d|horner)\(", text), text
    assert kernel.symbol in (REPO / kernel.source).read_text()


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="interpret-mode kernel runs are slow; set RUN_SLOW_TESTS=1",
)
@pytest.mark.parametrize("name", CURVES)
def test_plain_add_matches_pallas_interpret(name):
    from davinci_tpu.ec.pallas_add import point_add, point_add_fp2

    rspec, tspec, R, T = _curves(name)
    A_r, B_r, A_t, B_t, _ = _operands(rspec, tspec, R, T, N, 15)
    fn = point_add_fp2 if R.ops.coord_ndim == 2 else point_add
    _same(fn(R, A_r, B_r, interpret=True), T.add(A_t, B_t))
