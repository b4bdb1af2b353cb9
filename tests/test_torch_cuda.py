"""davinci_tpu_torch's CUDA kernels on the card (skipped without one).

The hand-written kernels B1 (G1 point add) and B7 (G2 point add) are held
limb for limb against their plain PyTorch version on the same CUDA
tensors, and the bucket-pipeline MSM that runs on them against a host sum.
This file imports nothing of the JAX package; on a machine without JAX
run it without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from davinci_tpu_torch import curves as C
from davinci_tpu_torch.ec import cuda_add, get_device_curve
from davinci_tpu_torch.msm import msm
from davinci_tpu_torch.msm.pippenger import scalars_to_limbs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _operands(dc, spec, n, seed):
    """n random pairs, projective (Z != 1), plus O+P, P+O, P+P, P+(-P)."""
    r = random.Random(seed)
    P = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r)) for _ in range(n)])
    Q = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r)) for _ in range(n)])
    PQ = cuda_add.rcb15_plain(dc, P, Q)
    ident = dc.identity((n,))
    lhs = (PQ, ident, P, P, P)
    rhs = (Q, P, ident, P, dc.neg(P))
    cat = lambda pts: tuple(torch.cat([p[c] for p in pts]) for c in range(3))
    return cat(lhs), cat(rhs)


@pytest.mark.parametrize("name", ["bn254_g1", "bn254_g2"])
def test_kernel_matches_plain(dev, name):
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    kernel = cuda_add.B7 if dc.ops.coord_ndim == 2 else cuda_add.B1
    A, B = _operands(dc, spec, 300, 1)
    before = kernel.launches
    got = dc.add(A, B)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for g, w in zip(got, cuda_add.rcb15_plain(dc, A, B)):
        assert torch.equal(g, w)
    # broadcast operands: one point against a batch
    one = tuple(a[:1] for a in A)
    for g, w in zip(dc.add(one, B), cuda_add.rcb15_plain(dc, one, B)):
        assert torch.equal(g, w)


def test_kernel_rejects_wrong_dtype(dev):
    dc = get_device_curve(C.bn254_g1, dev)
    P = tuple(a.to(torch.int64) for a in dc.identity((4,)))
    with pytest.raises(TypeError):
        dc.add(P, P)


@pytest.mark.parametrize("name", ["bn254_g1", "bn254_g2"])
def test_msm_on_the_card_matches_host(dev, name):
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    r = random.Random(2)
    n = 3000
    base = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    scalars = [r.randrange(spec.r) for _ in range(n)]
    scalars[:3] = [0, 1, spec.r - 1]
    out = msm(dc, dc.encode_points(pts),
              torch.as_tensor(scalars_to_limbs(spec, scalars), device=dev))
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    want = spec.infinity()
    for i, b in enumerate(base):
        want = want.add(b.mul(sum(scalars[i::8]) % spec.r))
    assert got == want
