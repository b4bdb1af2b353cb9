"""The scan-path MSM of davinci_tpu_torch (msm/bucket_kernel.py and the
scan branch of msm/pippenger.py) held against the JAX package on the CPU.

On CPU tensors every kernel wrapper (B2 bucket scan, B3 bucket reduce, B4
suffix reduce, B5 Horner) runs its plain PyTorch version, so these tests
pin the algorithm the CUDA kernels are held to on the card.  Inputs are
made with seeded host randomness and cross as numpy arrays.  The pipeline
is shrunk as in test_torch_msm.py: a scan width (COLS) of 16, a reduce
chunk (REDUCE_C) of 4, and, where the reference's pipeline is not met,
4-bit windows (16 buckets, 8 signed) in both packages.  The reference's
kernel-path functions run through their plain XLA counterparts, as its own
tests do on the CPU; its interpret-mode kernels are compared behind
RUN_SLOW_TESTS.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.msm import bucket_kernel as rbk
from davinci_tpu.msm import msm as ref_msm
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu_torch import convert
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16
from davinci_tpu_torch.kernels import KERNELS
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import pippenger as pp

torch.set_num_threads(1)

SPEC, RSPEC = TC.bn254_g1, RC.bn254_g1
L = 22


@pytest.fixture
def dc():
    return get_device_curve(SPEC, "cpu")


@pytest.fixture
def R(monkeypatch):
    # the reference's CPU branches (no interpret-mode kernels)
    monkeypatch.delenv("DAVINCI_MSM_KERNEL", raising=False)
    return ref_curve(RSPEC)


@pytest.fixture
def scan_cols(monkeypatch):
    # at 12-bit windows C = 32 keeps the plain reduce's sequential adds
    # few: 2K - 1 = 127 in B3 and 2C - 1 = 63 in B4
    monkeypatch.setattr(pp, "COLS", 16)
    monkeypatch.setattr(bk, "REDUCE_C", 32)


@pytest.fixture
def four_bit(monkeypatch, scan_cols):
    monkeypatch.setattr(bk, "REDUCE_C", 4)
    for mod in (pp, rpp):
        monkeypatch.setattr(mod, "WINDOW_BITS", 4)
        monkeypatch.setattr(mod, "NBUCKETS", 16)
        monkeypatch.setattr(mod, "SIGNED_NBUCKETS", 8)


def _j(t):
    return jnp.asarray(t.numpy())


def _same(ref, port):
    for a, b in zip(ref, port):
        assert np.array_equal(np.asarray(a), b.numpy())


def _host_points(n, seed, spec=SPEC):
    r = random.Random(seed)
    return [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(n)], r


def _projective(dc, n, seed):
    """n random points with Z != 1 as (n, L) x3, and their host values."""
    pts, _ = _host_points(2 * n, seed, dc.spec)
    enc = dc.encode_points(pts)
    out = dc.add(tuple(a[:n] for a in enc), tuple(a[n:] for a in enc))
    return out, [p.add(q) for p, q in zip(pts[:n], pts[n:])]


def _t(p, shape):
    """(N, L) x3 -> transposed (L, *shape) x3."""
    L = p[0].shape[-1]
    return tuple(a.T.reshape((L,) + shape).contiguous() for a in p)


def _decode_t(dc, p):
    """Transposed (L, ...) x3 -> host points in row-major batch order."""
    L = p[0].shape[0]
    return dc.decode_points(tuple(a.reshape(L, -1).T for a in p))


def _host_msm(pts, scalars, spec=SPEC):
    acc = spec.infinity()
    for p, s in zip(pts, scalars):
        acc = acc.add(p.mul(s))
    return acc


def _coords(pt):
    return None if pt is None or pt.infinity else (pt.x.v, pt.y.v)


# -- layouts -------------------------------------------------------------------


def test_sort_keys_and_planes_match_reference(dc, R):
    """Signed sort keys (carry chains through runs of 2047, 2048 and 4095
    digits) and packed planes (with an infinity point), element for
    element."""
    r = random.Random(41)
    w = 4096
    scalars = [0, 1, SPEC.r - 1, w**21 - 1,
               sum(2048 * w**j for j in range(21)),
               sum(2047 * w**j for j in range(21)),
               sum((2047 + j % 3) * w**j for j in range(21))]
    scalars += [r.randrange(SPEC.r) for _ in range(9)]
    S = pp.scalars_to_limbs(SPEC, scalars)
    assert np.array_equal(S, rpp.scalars_to_limbs(RSPEC, scalars))
    got = pp._signed_sort_keys(torch.as_tensor(S))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(rpp._signed_sort_keys(jnp.asarray(S))))

    pts, _ = _host_points(5, 42)
    pts[2] = SPEC.infinity()
    P = dc.affine_encoding(dc.encode_points(pts))
    packed, is_inf = bk.pack_points(dc, *P)
    want = rbk.pack_points(R, *(_j(a) for a in P))
    assert packed.dtype == torch.int32
    _same(want, (packed, is_inf))
    assert is_inf.tolist() == [p.infinity for p in pts]
    assert (packed < 0).any()  # y's planes do reach the int32 sign bit


def test_scalars_to_limbs_checks_the_signed_contract():
    class Full:
        r = (1 << 264) - 59  # fills all 22 windows: no room for the carry

    with pytest.raises(ValueError):
        pp.scalars_to_limbs(Full, [1])


# -- the transposed pipeline stages --------------------------------------------


def test_merge_leftovers_matches_reference(dc, R):
    """Lane-final runs (equal keys across lanes, one lane in the sink
    slot) folded into the buckets: limb-equal to the reference on every
    slot but the scratch."""
    Wt, cols, nb = 2, 8, 8
    nbp = nb + 2
    base, _ = _projective(dc, 12, 43)
    r = random.Random(44)
    pick = lambda k: tuple(a[[r.randrange(12) for _ in range(k)]] for a in base)
    buckets = _t(pick(Wt * nbp), (Wt, nbp))
    acc = _t(pick(Wt * cols), (Wt, cols))
    keys = torch.tensor([[0, 0, 0, 3, 5, 5, 7, 8],
                         [1, 2, 2, 2, 2, 6, 6, 6]], dtype=torch.int32)
    got = pp._merge_leftovers_t(dc, buckets, acc, keys)
    want = rpp._merge_leftovers_t(R, tuple(_j(a) for a in buckets),
                                  tuple(_j(a) for a in acc), _j(keys))
    _same(tuple(np.asarray(a)[:, :, :nbp - 1] for a in want),
          tuple(a[:, :, :nbp - 1] for a in got))


def test_plain_horner_matches_reference_horner_t(dc, R):
    """Plain B5 and the reference's _horner_t add in the same order: equal
    limbs; both equal sum_w 2^(12w) S_w."""
    W, B = 3, 2
    pts, hpts = _projective(dc, W * B, 45)
    sums = tuple(a.T.contiguous() for a in pts)  # (L, W*B), column w*B + b
    got = bk.horner_kernel(dc, sums, W, pp.WINDOW_BITS)
    _same(rpp._horner_t(R, tuple(_j(a) for a in sums), W), got)
    _same((a.numpy() for a in pp._horner_t(dc, sums, W)), got)
    for b, pt in enumerate(_decode_t(dc, got)):
        want = SPEC.infinity()
        for w in range(W):
            want = want.add(hpts[w * B + b].mul(1 << (12 * w)))
        assert pt == want


def test_plain_reduce_and_combine_match_reference(dc, R, monkeypatch):
    """Plain B3 (C = 4, K = 4) + B4 + _reduce_combine_t: the shifted
    window sums equal the reference's _bucket_reduce_t (its suffix-scan
    branch on the CPU) and the host's sum_i (i + 1) S_i."""
    monkeypatch.setattr(bk, "REDUCE_C", 4)
    Wt, nb = 2, 16
    pts, hpts = _projective(dc, 6, 46)
    r = random.Random(47)
    idx = [r.randrange(6) for _ in range(Wt * (nb + 2))]
    buckets = _t(tuple(a[idx] for a in pts), (Wt, nb + 2))
    got = _decode_t(dc, pp._bucket_reduce_t(dc, buckets, shifted=True))
    want = _decode_t(dc, tuple(torch.as_tensor(np.array(a)) for a in
                               rpp._bucket_reduce_t(
                                   R, tuple(_j(a) for a in buckets),
                                   shifted=True)))
    assert got == want
    for w in range(Wt):
        host = SPEC.infinity()
        for i in range(nb):
            host = host.add(hpts[idx[w * (nb + 2) + i]].mul(i + 1))
        assert got[w] == host


def test_bucket_reduce_reads_the_buckets_in_place(dc, monkeypatch):
    """_bucket_reduce_t hands B3 views of its (L, Wt, NB + 2) buckets (no
    copy), and B3's wrapper gives the same A and B on them as on
    contiguous copies."""
    monkeypatch.setattr(bk, "REDUCE_C", 4)
    Wt, nb = 2, 8
    pts, _ = _projective(dc, 6, 49)
    r = random.Random(50)
    idx = [r.randrange(6) for _ in range(Wt * (nb + 2))]
    buckets = _t(tuple(a[idx] for a in pts), (Wt, nb + 2))
    seen = []
    reduce = bk.bucket_reduce_kernel
    monkeypatch.setattr(bk, "bucket_reduce_kernel",
                        lambda c, b: seen.append(b) or reduce(c, b))
    pp._bucket_reduce_t(dc, buckets)
    (views,) = seen
    for v, b in zip(views, buckets):
        assert v.shape == (L, Wt, nb) and v.data_ptr() == b.data_ptr()
        assert v.stride() == b.stride()
    got = reduce(dc, views)
    want = reduce(dc, tuple(v.contiguous() for v in views))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def test_plain_suffix_reduce_matches_host(dc):
    K, M = 5, 3
    pts, hpts = _projective(dc, K * M, 48)
    s = torch.stack([torch.cat([a[k * M:(k + 1) * M].T for a in pts])
                     for k in range(K)])  # (K, 3L, M)
    A, B = bk.suffix_reduce_kernel(dc, s)
    split = lambda t: tuple(t[c * L:(c + 1) * L] for c in range(3))
    gotA, gotB = _decode_t(dc, split(A)), _decode_t(dc, split(B))
    for m in range(M):
        wa, wb = SPEC.infinity(), SPEC.infinity()
        for k in range(K):
            wa = wa.add(hpts[k * M + m])
            wb = wb.add(hpts[k * M + m].mul(k))
        assert gotA[m] == wa
        assert gotB[m] == wb


def test_plain_bucket_scan_buckets_match_host(dc, four_bit):
    """Plain B2 through bucket_accumulate_packed and the leftover merge:
    every merged bucket slot equals the host sum of its sign-applied
    points, built from the reference's signed keys (4-bit windows, four
    scan rows, runs across lanes, an infinity point)."""
    n, Wt, cols, snb = 64, 3, 16, 8
    pts, r = _host_points(n, 49)
    pts[5] = SPEC.infinity()
    scalars = [r.randrange(SPEC.r) for _ in range(n)]
    scalars[8:24] = [scalars[8]] * 16
    S = rpp.scalars_to_limbs(RSPEC, scalars)
    keys = np.asarray(rpp._signed_sort_keys(jnp.asarray(S)))[:, :Wt]
    P = dc.encode_points(pts)
    packed, is_inf = bk.pack_points(dc, *P)
    buckets, acc, acc_key = bk.bucket_accumulate_packed(
        dc, packed, is_inf, torch.as_tensor(keys.T.copy()), cols, snb,
        signed=True)
    merged = pp._merge_leftovers_t(dc, buckets, acc, acc_key)
    got = _decode_t(dc, tuple(a[:, :, :snb] for a in merged))
    for w in range(Wt):
        for i in range(snb):
            want = SPEC.infinity()
            for p, k in zip(pts, keys[:, w]):
                if k >> 1 == i and not p.infinity:
                    want = want.add(p.neg() if k & 1 else p)
            assert got[w * snb + i] == want, (w, i)


# -- the scan path end to end --------------------------------------------------


def _edge_case():
    pts, r = _host_points(64, 3101)
    pts[5] = SPEC.infinity()
    scalars = [r.randrange(SPEC.r) for _ in pts]
    scalars[:3] = [0, 1, SPEC.r - 1]
    scalars[8:24] = [scalars[8]] * 16
    return pts, scalars


CASES = {
    "edge_scalars": _edge_case,
    "all_in_one_bucket": lambda: (_host_points(64, 77)[0],
                                  [12345678901234567890] * 64),
    "pads_to_the_scan_width": lambda: (
        _host_points(21, 78)[0],
        [random.Random(79).randrange(SPEC.r) for _ in range(21)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_msm_scan_matches_host(dc, four_bit, case):
    pts, scalars = CASES[case]()
    P = dc.encode_points(pts)
    S = torch.as_tensor(pp.scalars_to_limbs(SPEC, scalars))
    before = [k.launches for k in KERNELS]
    got = dc.decode_points(tuple(a[None] for a in pp._msm_scan(dc, P, S)))[0]
    assert got == _host_msm(pts, scalars)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert [k.launches for k in KERNELS] == before


def test_msm_scan_matches_reference_msm(dc, R, scan_cols):
    """12-bit windows (2,048 signed buckets, C = 32): the scan path with
    precomputed planes equals the reference's msm and the host."""
    pts, scalars = _edge_case()
    P = dc.encode_points(pts)
    S = pp.scalars_to_limbs(SPEC, scalars)
    out = pp._msm_scan(dc, P, torch.as_tensor(S),
                       precomp=bk.pack_points(dc, *P))
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    want = R.decode_points(tuple(
        a[None] for a in ref_msm(R, tuple(_j(a) for a in P), jnp.asarray(S))))[0]
    assert _coords(got) == _coords(want)
    assert got == _host_msm(pts, scalars)


def test_msm_routes(dc, monkeypatch):
    """CPU tensors take the plain MSM; with the pipeline on, G1 takes the
    scan path and G2 the fused one."""
    calls = []
    for name in ("_msm_scan", "_msm_fused", "_msm_plain"):
        monkeypatch.setattr(pp, name, lambda *a, _n=name, **k: calls.append(_n))
    g2 = get_device_curve(TC.bn254_g2, "cpu")
    P1, P2 = dc.identity((2,)), g2.identity((2,))
    S = torch.zeros((2, 22), dtype=torch.int32)
    pp.msm(dc, P1, S)
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: True)
    pp.msm(dc, P1, S)
    pp.msm(g2, P2, S)
    assert calls == ["_msm_plain", "_msm_scan", "_msm_fused"]


# -- the slice as a whole --------------------------------------------------------


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


def test_groth16_on_the_scan_path_matches_reference(R, scan_cols, monkeypatch):
    """The pipeline forced on for CPU tensors: every G1 MSM of the prove
    takes the scan path (packed bases, B2-B5 and the leftover merge, all
    plain).  With fixed r/s the proof equals the reference's and
    verifies.  G2 takes the plain MSM here: its fused pipeline at 12-bit
    windows takes minutes on the CPU (test_torch_msm.py holds it against
    the reference)."""
    scans = []
    real_scan = pp._msm_scan
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: True)
    monkeypatch.setattr(
        pp, "_msm_scan", lambda *a, **k: scans.append(k) or real_scan(*a, **k))
    monkeypatch.setattr(pp, "_msm_fused", pp._msm_plain)
    x = 3
    y = x**3 + x + 5
    ref, port = RefGroth16("bn254"), Groth16("bn254", device="cpu")
    rpk, rvk = ref.setup(_circuit(RefCS, x, y))
    pk = convert.proving_key_from_reference(rpk, port.g1, port.g2)
    vk = convert.verifying_key_from_reference(rvk, port.g1, port.g2)
    want = ref.prove(rpk, _circuit(RefCS, x, y), r_rand=7, s_rand=11)
    got = port.prove(pk, _circuit(ConstraintSystem, x, y), r_rand=7, s_rand=11)
    assert len(scans) == 4 and all(k["precomp"] is not None for k in scans)
    for part in ("a", "b", "c"):
        assert _coords(getattr(got, part)) == _coords(getattr(want, part))
    assert port.verify(vk, got, [y])
    assert not port.verify(vk, got, [y + 1])


# -- L = 32: BLS12-381 G1, the blob commitment's curve ----------------------------


@pytest.fixture
def dc381():
    return get_device_curve(TC.bls381_g1, "cpu")


@pytest.fixture
def R381(monkeypatch):
    monkeypatch.delenv("DAVINCI_MSM_KERNEL", raising=False)
    return ref_curve(RC.bls381_g1)


def test_l32_planes_and_stages_match_reference(dc381, R381, monkeypatch):
    """At L = 32 (24 packed planes): the planes and plain B5 equal the
    reference's limb for limb; plain B3 + B4 through _bucket_reduce_t
    (C = 4, K = 4) equal its window sums (its CPU branch adds in another
    order, so the points are compared)."""
    monkeypatch.setattr(bk, "REDUCE_C", 4)
    pts, _ = _host_points(6, 52, TC.bls381_g1)
    pts[3] = TC.bls381_g1.infinity()
    P = dc381.affine_encoding(dc381.encode_points(pts))
    packed, is_inf = bk.pack_points(dc381, *P)
    assert packed.shape == (6, 24)
    _same(rbk.pack_points(R381, *(_j(a) for a in P)), (packed, is_inf))

    Wt, nb = 2, 16
    proj, _ = _projective(dc381, 6, 53)
    r = random.Random(54)
    idx = [r.randrange(6) for _ in range(Wt * (nb + 2))]
    buckets = _t(tuple(a[idx] for a in proj), (Wt, nb + 2))
    want = rpp._bucket_reduce_t(R381, tuple(_j(a) for a in buckets),
                                shifted=True)
    assert _decode_t(dc381, pp._bucket_reduce_t(dc381, buckets, shifted=True)) \
        == _decode_t(dc381, tuple(torch.as_tensor(np.array(a)) for a in want))

    W, B = 3, 2
    sums = tuple(a.T.contiguous() for a in proj)  # (L, W * B)
    _same(rpp._horner_t(R381, tuple(_j(a) for a in sums), W),
          bk.horner_kernel(dc381, sums, W, pp.WINDOW_BITS))


def test_l32_msm_scan_matches_reference_msm(dc381, R381, scan_cols):
    """The scan path at L = 32 (plain B2-B5, scan width 16, C = 32) with
    precomputed planes equals the reference's msm and the host, with
    scalars 0, 1 and r - 1, a run of equal scalars and an infinity base."""
    spec = TC.bls381_g1
    pts, r = _host_points(24, 55, spec)
    pts[5] = spec.infinity()
    scalars = [r.randrange(spec.r) for _ in pts]
    scalars[:3] = [0, 1, spec.r - 1]
    scalars[8:20] = [scalars[8]] * 12
    P = dc381.encode_points(pts)
    S = pp.scalars_to_limbs(spec, scalars)
    out = pp._msm_scan(dc381, P, torch.as_tensor(S),
                       precomp=bk.pack_points(dc381, *P))
    got = dc381.decode_points(tuple(a[None] for a in out))[0]
    want = R381.decode_points(tuple(a[None] for a in ref_msm(
        R381, tuple(_j(a) for a in P), jnp.asarray(S))))[0]
    assert _coords(got) == _coords(want)
    assert got == _host_msm(pts, scalars, spec)


# -- the repairs -------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    import inspect

    from davinci_tpu_torch.ec.weier import DeviceCurve
    from davinci_tpu_torch.ff.mod import DeviceField, get_device_field
    from davinci_tpu_torch.ff.quad import get_device_quad
    from davinci_tpu_torch.groth16.witness_dev import DeviceCSR
    from davinci_tpu_torch.ntt.ntt import DeviceNTT, get_device_ntt

    for fn in (Groth16.__init__, DeviceCurve.__init__, get_device_curve,
               DeviceField.__init__, get_device_field, get_device_quad,
               DeviceNTT.__init__, get_device_ntt, DeviceCSR.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert get_device_curve(SPEC).ops.one_mont.device.type == "cuda"
    else:
        # no card: a default-device object raises at its first use
        with pytest.raises((AssertionError, RuntimeError)):
            get_device_curve(TC.bn254_g2)


def test_kernel_registry_lists_the_slice():
    assert [k.name for k in KERNELS] == [
        "point_add_g1", "bucket_scan_g1", "bucket_reduce_g1",
        "suffix_reduce_g1", "horner_g1", "mont_mul", "point_add_g2",
        "horner_g2",
        "point_add_g1_l32", "bucket_scan_g1_l32", "bucket_reduce_g1_l32",
        "suffix_reduce_g1_l32", "horner_g1_l32", "mont_mul_l32",
        "point_add_g2_l32", "horner_g2_l32",
        "addk_v2d", "addk_lazy", "addk_kara", "addk_addonly",
        "point_add_g1_l64", "bucket_scan_g1_l64", "bucket_reduce_g1_l64",
        "suffix_reduce_g1_l64", "horner_g1_l64", "mont_mul_l64"]
    assert [k.limbs for k in KERNELS] == ([22] * 8 + [32] * 8 + [22] * 4
                                          + [64] * 6)


# -- the reference's interpret-mode kernels ---------------------------------------


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="interpret-mode Pallas kernels are slow; set RUN_SLOW_TESTS=1",
)
def test_plain_kernels_match_pallas_interpret(dc, R):
    """The reference's _bucket_scan, suffix_reduce_kernel and
    horner_kernel in interpret mode against plain B2, B4 and B5, limb for
    limb, at the tiniest BN254 G1 shapes."""
    rows, nl = 3, 4
    pts, _ = _host_points(rows * nl, 50)
    P = dc.encode_points(pts)
    packed, _ = bk.pack_points(dc, *P)
    pts_arr = packed.reshape(rows, nl, -1).transpose(1, 2).contiguous()
    keys = torch.tensor([[0, 1, 4, 6], [0, 3, 4, 9], [2, 3, 5, 9]],
                        dtype=torch.int32)
    _same([rbk._bucket_scan(R, _j(pts_arr), _j(keys), True, True)],
          [bk._bucket_scan(dc, pts_arr, keys, True)])

    K, M = 2, 128
    proj, _ = _projective(dc, 8, 51)
    idx = torch.arange(K * M) % 8
    s = torch.stack([torch.cat([a[idx[k * M:(k + 1) * M]].T for a in proj])
                     for k in range(K)])
    _same(rbk.suffix_reduce_kernel(R, _j(s), interpret=True),
          bk.suffix_reduce_kernel(dc, s))

    sums = tuple(a[:2].T.contiguous() for a in proj)  # W = 2, B = 1
    _same(rbk.horner_kernel(R, tuple(_j(a) for a in sums), 2, interpret=True),
          bk.horner_kernel(dc, sums, 2, pp.WINDOW_BITS))
