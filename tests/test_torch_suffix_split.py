"""B4's split order (msm/bucket_kernel.py `_suffix_reduce_split_plain`,
the order the CUDA suffix reduce adds in) held against the reference's
order on the CPU.

The kernel walks the K rows in chunks of T on parallel threads and
combines the chunk sums, so its output is the reference's pair of points
A = sum_k s_k, B = sum_k k s_k in another projective representative.  So
the split plain version is compared as points: with the port's plain
version of the reference's walk (`_suffix_reduce_plain`, the CPU route),
with that walk run on the JAX package's own point add (the reference
kernel's loop, `davinci_tpu/msm/bucket_kernel.py::_suffix_reduce_kernel`;
the kernel itself runs in interpret mode only behind RUN_SLOW_TESTS, in
test_torch_msm_scan.py), and with host sums.  Then the split order replaces
the CPU route inside the scan-path MSM and the Groth16 prove, whose
results must equal the reference's.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.msm import msm as ref_msm
from davinci_tpu_torch import convert
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import pippenger as pp

torch.set_num_threads(1)

M = 3  # lanes; lane 1 is all identity columns


def _stacked_points(dc, K, seed):
    """(K, 3L, M) point columns of projective points (Z != 1), lane 1 the
    identity, and the host points (None for the identity)."""
    spec = dc.spec
    r = random.Random(seed)
    host = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(2 * K * M)]
    enc = dc.encode_points(host)
    half = K * M
    pts = dc.add(tuple(a[:half] for a in enc), tuple(a[half:] for a in enc))
    sums = [p.add(q) for p, q in zip(host[:half], host[half:])]
    s = torch.stack([bk._columns(tuple(a[k * M:(k + 1) * M] for a in pts))
                     for k in range(K)])
    s[:, :, 1] = bk._columns(dc.identity((1,)))[:, 0]
    grid = [[None if m == 1 else sums[k * M + m] for m in range(M)]
            for k in range(K)]
    return s, grid


def _points(dc, cols):
    """(3L, M) point columns -> host points."""
    L = dc.df.L
    return dc.decode_points(tuple(cols[c * L:(c + 1) * L].T for c in range(3)))


def _reference_walk(R, s):
    """The reference kernel's loop on the JAX package's point add: run +=
    s_k from the top row down, B += run for k > 0."""
    K, L3, _ = s.shape
    L = L3 // 3
    S = np.asarray(s).reshape(K, 3, L, M).transpose(1, 0, 3, 2)
    run = bacc = R.identity((M,))
    for k in reversed(range(K)):
        run = R.add(run, tuple(jnp.asarray(a) for a in S[:, k]))
        if k:
            bacc = R.add(bacc, run)
    back = lambda p: torch.as_tensor(
        np.concatenate([np.asarray(a).T for a in p], axis=0))
    return back(run), back(bacc)


@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1"])
@pytest.mark.parametrize("K,T", [(1, 4), (5, 4), (7, 2), (32, 16)])
def test_split_order_gives_the_reference_points(name, K, T):
    dc = get_device_curve(getattr(TC, name), "cpu")
    R = ref_curve(getattr(RC, name))
    s, grid = _stacked_points(dc, K, 60 + K)
    A, B = bk._suffix_reduce_split_plain(dc, s, T)
    A0, B0 = bk._suffix_reduce_plain(dc, s)
    Ar, Br = _reference_walk(R, s)
    # the port's CPU route is the reference's walk, limb for limb
    assert torch.equal(A0, Ar) and torch.equal(B0, Br)
    got_a, got_b = _points(dc, A), _points(dc, B)
    assert got_a == _points(dc, A0) and got_b == _points(dc, B0)
    inf = dc.spec.infinity()
    for m in range(M):
        want_a = want_b = inf
        for k in range(K):
            pt = grid[k][m] or inf
            want_a = want_a.add(pt)
            want_b = want_b.add(pt.mul(k))
        assert (got_a[m], got_b[m]) == (want_a, want_b), m


def test_suffix_chunk():
    assert [bk.suffix_chunk(K) for K in (1, 2, 5, 7, 32, 256, 257)] == [
        1, 2, 4, 4, 8, 16, 32]
    assert -(-(1 << 16) // bk.suffix_chunk(1 << 16)) <= bk.SUFFIX_MAX_CHUNKS


@pytest.fixture
def split_route(monkeypatch):
    """The CPU route of suffix_reduce_kernel in B4's order (the CUDA
    kernel's chunk size)."""
    calls = []

    def split(curve, s):
        calls.append(s.shape)
        return bk._suffix_reduce_split_plain(curve, s, bk.suffix_chunk(s.shape[0]))

    monkeypatch.setattr(bk, "_suffix_reduce_plain", split)
    # scan width 16; C = 32 lanes per window chunk, so B4 walks K = 32
    monkeypatch.setattr(pp, "COLS", 16)
    monkeypatch.setattr(bk, "REDUCE_C", 32)
    monkeypatch.delenv("DAVINCI_MSM_KERNEL", raising=False)
    return calls


def _coords(pt):
    return None if pt is None or pt.infinity else (pt.x.v, pt.y.v)


def test_msm_scan_in_split_order_matches_reference(split_route):
    spec = TC.bn254_g1
    dc = get_device_curve(spec, "cpu")
    R = ref_curve(RC.bn254_g1)
    r = random.Random(3101)
    pts = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(64)]
    pts[5] = spec.infinity()
    scalars = [r.randrange(spec.r) for _ in pts]
    scalars[:3] = [0, 1, spec.r - 1]
    scalars[8:24] = [scalars[8]] * 16
    P = dc.encode_points(pts)
    S = pp.scalars_to_limbs(spec, scalars)
    out = pp._msm_scan(dc, P, torch.as_tensor(S))
    assert split_route == [(32, 66, 44)]
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    want = R.decode_points(tuple(a[None] for a in ref_msm(
        R, tuple(jnp.asarray(a.numpy()) for a in P), jnp.asarray(S))))[0]
    assert _coords(got) == _coords(want)
    host = spec.infinity()
    for p, k in zip(pts, scalars):
        host = host.add(p.mul(k))
    assert got == host


def _circuit(CS, x, y):
    """The circuit of test_torch_groth16.py: x^3 + x + 5 == y."""
    cs = CS(TF.BN254_R)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    w = cs.priv_input(x + 2)
    x3 = cs.mul(cs.mul(xv, xv), xv)
    cs.assert_eq(x3 + xv + 5, yv)
    cs.mul(w * 3 + xv, w + 1)
    return cs


def test_groth16_in_split_order_matches_reference(split_route, monkeypatch):
    """Every G1 MSM of the prove on the scan path with B4 in split order
    (G2 on the plain MSM, as in test_torch_msm_scan.py): with fixed r/s
    the proof equals the reference's and verifies."""
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: True)
    monkeypatch.setattr(pp, "_msm_fused", pp._msm_plain)
    x = 3
    y = x**3 + x + 5
    ref, port = RefGroth16("bn254"), Groth16("bn254", device="cpu")
    rpk, rvk = ref.setup(_circuit(RefCS, x, y))
    pk = convert.proving_key_from_reference(rpk, port.g1, port.g2)
    vk = convert.verifying_key_from_reference(rvk, port.g1, port.g2)
    want = ref.prove(rpk, _circuit(RefCS, x, y), r_rand=7, s_rand=11)
    got = port.prove(pk, _circuit(ConstraintSystem, x, y), r_rand=7, s_rand=11)
    assert len(split_route) == 4
    for part in ("a", "b", "c"):
        assert _coords(getattr(got, part)) == _coords(getattr(want, part))
    assert port.verify(vk, got, [y])
    assert not port.verify(vk, got, [y + 1])
