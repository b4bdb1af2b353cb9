"""davinci_tpu_torch's CUDA kernels on the card (skipped without one).

The hand-written kernels B1 (G1 point add, on limb-major planes and
through the row wrapper), B7 (G2 point add), the scan
path's B2-B5 (bucket scan, bucket reduce, suffix reduce, Horner), B5's
G2 build (the fused route's Horner) and B6 (Montgomery product, at
block-tile edges, on broadcast, repeating and raw operands) are held
limb for limb against their plain PyTorch versions on the same CUDA
tensors, each launch counted once, at L = 22 and, for B1, B2, B4, B5,
B6 and B7, at L = 32 (BLS12-381, and BLS12-377's G2, whose Fp2 has
u^2 = -5), and for B1-B6 at L = 64 (BW6-761: G1, whose 3b = -3 B2 takes
as a negated small integer, and G2, both over Fp; B6's blocks of 64
rows there); B4 against the plain version of its split order; B2 and B5
on edge inputs in both forms of their products by b3.  The MSMs that run on them (the scan path for G1, the fused
pipeline for G2) are held against a host sum, `msm_many` and the
EIP-7594 cell proofs against their plain route on the card.  B8, the
point-add experiment's four designs of the BN254 G1 add
(ec/addk_exp.py), is held against its plain versions and, for the three
that compute the canonical add, against B1.
This file imports nothing of the JAX package; on a machine without JAX
run it without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from davinci_tpu_torch import curves as C
from davinci_tpu_torch import fields as F
from davinci_tpu_torch import kernels as K
from davinci_tpu_torch.ec import addk_exp, cuda_add, get_device_curve
from davinci_tpu_torch.ff import cuda_mul, get_device_field
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import msm
from davinci_tpu_torch.msm import pippenger as pp
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


@pytest.mark.parametrize(
    "name", ["bn254_g1", "bn254_g2", "bls381_g1", "bls377_g2", "bls381_g2",
             "bw6_g1", "bw6_g2"])
def test_kernel_matches_plain(dev, name):
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    kernel = cuda_add.B7 if dc.ops.coord_ndim == 2 else cuda_add.B1
    kernel = kernel.at(dc.df.L)
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
    # batches that end inside a warp's five G2 adds or a block's ten
    for n in (1, 4, 7, 11):
        a, b = tuple(x[:n] for x in A), tuple(x[-n:] for x in B)
        for g, w in zip(dc.add(a, b), cuda_add.rcb15_plain(dc, a, b)):
            assert torch.equal(g, w)


def test_kernel_rejects_wrong_dtype(dev):
    dc = get_device_curve(C.bn254_g1, dev)
    P = tuple(a.to(torch.int64) for a in dc.identity((4,)))
    with pytest.raises(TypeError):
        dc.add(P, P)


def _near_p_g1(dc, hosts):
    """The host points rescaled projectively, (l x, l y, l), so that Z, X
    or Y is p - 1 in Montgomery form (l = -R^-1, -R^-1 / x, -R^-1 / y)."""
    p = dc.spec.field_spec.p
    Rinv = pow(1 << (12 * dc.df.L), -1, p)

    def rescaled(scale):
        lams = [-Rinv * scale(pt) % p for pt in hosts]
        return tuple(dc.df.encode([lam * v % p for lam, v in zip(lams, vals)])
                     for vals in ([pt.x.v for pt in hosts],
                                  [pt.y.v for pt in hosts], [1] * len(hosts)))

    return (rescaled(lambda pt: 1), rescaled(lambda pt: pow(pt.x.v, -1, p)),
            rescaled(lambda pt: pow(pt.y.v, -1, p)))


def _g1_hard_cases(dc, hosts):
    """O + B, B + O, B + B, B + (-B), O + O, then sums of points near
    p - 1, two representations of one point, and P + (-P) among them."""
    base = dc.encode_points(hosts)
    ident = dc.identity((len(hosts),))
    nz, nx, ny = _near_p_g1(dc, hosts)
    roll = lambda pt: tuple(torch.roll(c, 3, 0) for c in pt)
    lhs = (ident, base, base, base, ident, nz, nx, ny, nz, nx)
    rhs = (base, ident, base, dc.neg(base), ident, roll(nx), roll(ny),
           roll(nz), nx, dc.neg(ny))
    cat = lambda pts: tuple(torch.cat([pt[c] for pt in pts]) for c in range(3))
    return cat(lhs), cat(rhs)


def _planes(t):
    return tuple(a.T.contiguous() for a in t)


@pytest.mark.parametrize("n", [1, 22, 45063])
@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1", "bw6_g1",
                                  "bw6_g2"])
def test_b1_planes_and_rows_match_plain(dev, name, n):
    """B1 on (L, n) planes and through the row wrapper: n sums of random
    points (ending inside a block at 1, 22 and 45,063), then the edge and
    near-p cases; one launch each."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    kernel = K.B1.at(dc.df.L)
    r = random.Random(16)
    hosts = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(16)]
    base = dc.encode_points(hosts)
    i = torch.arange(n, device=dev)
    A = cuda_add.rcb15_plain(dc, tuple(a[i % 16] for a in base),
                             tuple(a[(i // 16) % 16] for a in base))
    B = tuple(torch.roll(a, 5, 0) for a in A)
    for P, Q in ((A, B), _g1_hard_cases(dc, hosts)):
        want = cuda_add.rcb15_plain(dc, P, Q)
        _equal_once(kernel, lambda: dc.add(P, Q), lambda: want)
        _equal_once(kernel,
                    lambda: cuda_add.point_add_planes(dc, _planes(P),
                                                      _planes(Q)),
                    lambda: _planes(want))


def test_b1_planes_take_the_scan_layout(dev):
    """(L, Wt, cols) planes, and views of a wider array (the combine's
    slices), as the scan path passes them."""
    dc = get_device_curve(C.bn254_g1, dev)
    P = _projective(dc, 2 * 3 * 40, 17)
    wide = tuple(a.T.reshape(22, 6, 40) for a in P)
    p = tuple(a[:, :3] for a in wide)
    q = tuple(a[:, 3:] for a in wide)
    got = cuda_add.point_add_planes(dc, p, q)
    rows = lambda t: tuple(a.reshape(22, -1).T for a in t)
    want = cuda_add.rcb15_plain(dc, rows(p), rows(q))
    for g, w in zip(got, want):
        assert g.shape == (22, 3, 40) and g.is_contiguous()
        assert torch.equal(g.reshape(22, -1).T, w)


@pytest.mark.parametrize("name",
                         ["bn254_g1", "bn254_g2", "bls381_g1", "bls377_g2",
                          "bw6_g1", "bw6_g2"])
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


def _equal_once(kernel, run, plain):
    before = kernel.launches
    got = run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain()
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)


def _flat(t):
    if isinstance(t, (tuple, list)):
        return [x for part in t for x in _flat(part)]
    return [t]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _projective(dc, n, seed):
    r = random.Random(seed)
    P = dc.encode_points([C.bn254_g1.gen.mul(r.randrange(1, C.bn254_g1.r))
                          for _ in range(2 * n)])
    return cuda_add.rcb15_plain(dc, tuple(a[:n] for a in P),
                                tuple(a[n:] for a in P))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1", "bw6_g1",
                                  "bw6_g2"])
def test_bucket_scan_matches_plain(dev, signed, name):
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    r = random.Random(3)
    rows, nl = 5, 300
    pts = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(rows * nl)]
    packed, _ = bk.pack_points(dc, *dc.encode_points(pts))
    pts_arr = packed.reshape(rows, nl, -1).transpose(1, 2).contiguous()
    keys = torch.randint(0, 9, (rows, nl), generator=_gen(4))
    keys = torch.sort(keys, dim=0).values.to(torch.int32).to(dev)
    _equal_once(K.B2.at(dc.df.L),
                lambda: bk._bucket_scan(dc, pts_arr, keys, signed),
                lambda: bk._bucket_scan_plain(dc, pts_arr, keys, signed))


@pytest.mark.parametrize("name, Wt, NB", [
    ("bn254_g1", 3, 512),     # C = 256, K = 2
    ("bn254_g1", 22, 2048),   # c1's shape: K = 8
    ("bls381_g1", 22, 2048),  # the blob's, at L = 32
    ("bn254_g1", 3, 64),      # NB < 256: C = NB, K = 1
    ("bls381_g1", 5, 4),      # 20 lanes: a partial block across windows
    ("bw6_g1", 5, 2048),      # L = 64
])
def test_bucket_reduce_matches_plain(dev, name, Wt, NB):
    """B3 on the first NB slots of (L, Wt, NB + 2) buckets, as the MSM
    passes them (views, read in place), with identity slots."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    L = dc.df.L
    r = random.Random(5)
    pts = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r))
                            for _ in range(128)])
    P = cuda_add.rcb15_plain(dc, tuple(a[:64] for a in pts),
                             tuple(a[64:] for a in pts))
    idx = torch.randint(0, 64, (Wt * (NB + 2),), generator=_gen(6)).to(dev)
    full = tuple(a[idx].T.reshape(L, Wt, NB + 2).contiguous() for a in P)
    ident = dc.identity((1,))
    for a, v in zip(full, ident):
        a[:, 0, 1] = v[0]
    buckets = tuple(a[:, :, :NB] for a in full)
    C_ = bk.REDUCE_C if NB % bk.REDUCE_C == 0 else NB
    _equal_once(K.B3.at(L), lambda: bk.bucket_reduce_kernel(dc, buckets),
                lambda: bk._bucket_reduce_plain(dc, buckets, C_))


@pytest.mark.parametrize("Kr", [1, 4, 5, 7, 32, 256])
@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1", "bw6_g1"])
def test_suffix_reduce_matches_plain(dev, name, Kr):
    """B4 adds in chunks (`suffix_chunk`): limb-equal to the split plain
    version, and the same points as the reference's walk."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    L, M = dc.df.L, 200
    r = random.Random(7)
    pts = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r))
                            for _ in range(128)])
    P = cuda_add.rcb15_plain(dc, tuple(a[:64] for a in pts),
                             tuple(a[64:] for a in pts))
    idx = torch.randint(0, 64, (Kr * M,), generator=_gen(8)).to(dev)
    s = torch.cat([a[idx].reshape(Kr, M, L).transpose(1, 2) for a in P],
                  dim=1).contiguous()
    s[:, :, 3] = bk._columns(dc.identity((1,)))[:, 0]  # an identity lane
    T = bk.suffix_chunk(Kr)
    _equal_once(K.B4.at(L), lambda: bk.suffix_reduce_kernel(dc, s),
                lambda: bk._suffix_reduce_split_plain(dc, s, T))
    split = lambda t: tuple(t[c * L:(c + 1) * L].T for c in range(3))
    for got, want in zip(bk.suffix_reduce_kernel(dc, s),
                         bk._suffix_reduce_plain(dc, s)):
        assert dc.decode_points(split(got)) == dc.decode_points(split(want))


def test_horner_matches_plain(dev):
    dc = get_device_curve(C.bn254_g1, dev)
    W, B = 4, 130
    P = _projective(dc, W * B, 9)
    sums = tuple(a.T.contiguous() for a in P)
    _equal_once(K.B5, lambda: bk.horner_kernel(dc, sums, W, pp.WINDOW_BITS),
                lambda: bk._horner_plain(dc, sums, W, pp.WINDOW_BITS))


@pytest.mark.parametrize("nl", [1, 7, 23, 301])
@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1", "bw6_g1"])
def test_bucket_scan_edges(dev, name, nl):
    """B2 with lane counts that end inside a warp's five groups and a
    block's twenty, runs of one point added to itself (the doubling case
    of the complete mixed add) and signed runs that cross the sign
    boundary (2b then 2b + 1)."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    r = random.Random(11)
    rows = 6
    base = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(5)]
    pts = [base[r.randrange(5)] for _ in range(rows * nl)]
    packed, _ = bk.pack_points(dc, *dc.encode_points(pts))
    pts_arr = packed.reshape(rows, nl, -1).transpose(1, 2).contiguous()
    pts_arr[:, :, 0] = pts_arr[0, :, 0]  # lane 0: one point, one bucket
    keys = torch.randint(0, 6, (rows, nl), generator=_gen(12))
    keys = torch.sort(keys, dim=0).values.to(torch.int32)
    keys[:, 0] = torch.tensor([4, 4, 4, 5, 5, 5])
    keys = keys.to(dev).contiguous()
    for signed in (False, True):
        _equal_once(
            K.B2.at(dc.df.L),
            lambda: bk._bucket_scan(dc, pts_arr, keys, signed),
            lambda: bk._bucket_scan_plain(dc, pts_arr, keys, signed))


@pytest.mark.parametrize("B", [1, 3, 7, 131])
@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1", "bw6_g1"])
def test_horner_edges(dev, name, B):
    """B5 with identity windows (the top one of column 0, a lower one of
    every column) and column counts that end inside a warp's groups."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    L, W = dc.df.L, 3
    r = random.Random(13)
    pts = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r))
                            for _ in range(2 * W * B)])
    P = cuda_add.rcb15_plain(dc, tuple(a[:W * B] for a in pts),
                             tuple(a[W * B:] for a in pts))
    sums = tuple(a.T.contiguous() for a in P)  # column w * B + b
    for a, i in zip(sums, dc.identity((1,))):
        a[:, (W - 1) * B] = i[0]
        a[:, B:2 * B] = i[0][:, None]
    _equal_once(K.B5.at(L),
                lambda: bk.horner_kernel(dc, sums, W, pp.WINDOW_BITS),
                lambda: bk._horner_plain(dc, sums, W, pp.WINDOW_BITS))


@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("name", ["bn254_g2", "bls377_g2", "bls381_g2"])
def test_horner_g2_matches_plain(dev, name, B):
    """B5's G2 build against its plain version, with an identity window,
    on the three G2 curves (L = 22 and 32, u^2 = -1 and -5)."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    W = 4
    r = random.Random(14)
    pts = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r))
                            for _ in range(2 * W * B)])
    P = cuda_add.rcb15_plain(dc, tuple(a[:W * B] for a in pts),
                             tuple(a[W * B:] for a in pts))
    sums = tuple(a.reshape((W, B) + dc._eshape).contiguous() for a in P)
    for a, i in zip(sums, dc.identity(())):
        a[1] = i
    _equal_once(K.B5G2.at(dc.df.L),
                lambda: bk.horner_g2_kernel(dc, sums, pp.WINDOW_BITS),
                lambda: bk._horner_rows_plain(dc, sums, pp.WINDOW_BITS))


@pytest.mark.parametrize("name", ["bn254_g2", "bls377_g2"])
def test_g2_msm_combines_windows_in_one_launch(dev, name):
    """`msm` of a G2 set takes one launch of B5's G2 build and no G2 add
    of a single point."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    r = random.Random(15)
    n = 2048
    base = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(4)]
    scalars = [r.randrange(spec.r) for _ in range(n)]
    kernel = K.B5G2.at(dc.df.L)
    before = kernel.launches
    sizes = []
    add = cuda_add.point_add_fp2

    def counted(curve, p, q):
        sizes.append(torch.broadcast_shapes(p[0].shape, q[0].shape)[:-2])
        return add(curve, p, q)

    cuda_add.point_add_fp2 = counted
    try:
        out = msm(dc, dc.encode_points([base[i % 4] for i in range(n)]),
                  torch.as_tensor(scalars_to_limbs(spec, scalars), device=dev))
    finally:
        cuda_add.point_add_fp2 = add
    assert kernel.launches == before + 1
    assert all(torch.Size(s).numel() > 1 for s in sizes)
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    want = spec.infinity()
    for i, b in enumerate(base):
        want = want.add(b.mul(sum(scalars[i::4]) % spec.r))
    assert got == want


def test_scan_msm_launches_every_kernel(dev):
    """`msm` of a G1 set on the card takes the scan path: one launch each
    of B2-B4, two of B5 (the combine's doubling chain and Horner) and 13
    of B1 (11 log-steps and one merge of the leftovers, the shifted sum)
    for one window tile, and the result equals the host sum."""
    spec = C.bn254_g1
    dc = get_device_curve(spec, dev)
    r = random.Random(10)
    n = 5000
    base = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(7)]
    base.append(spec.infinity())
    scalars = [r.randrange(spec.r) for _ in range(n)]
    scalars[:3] = [0, 1, spec.r - 1]
    kernels = (K.B1, K.B2, K.B3, K.B4, K.B5)
    before = [k.launches for k in kernels]
    out = msm(dc, dc.encode_points([base[i % 8] for i in range(n)]),
              torch.as_tensor(scalars_to_limbs(spec, scalars), device=dev))
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    steps = pp.COLS.bit_length() - 1
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        steps + 2, 1, 1, 1, 2]
    want = spec.infinity()
    for i, b in enumerate(base):
        want = want.add(b.mul(sum(scalars[i::8]) % spec.r))
    assert got == want


@pytest.mark.parametrize("name", ["bn254_g1", "bls381_g1"])
def test_msm_many_matches_plain_route(dev, name, monkeypatch):
    """`msm_many` of M = 3 scalar rows over one G1 set on the card: the
    scan route (the M*W window rows through B2-B4 and B1, one B5 combine
    of all M) equals the plain route (one plain MSM per m) on the same
    CUDA tensors, and the host sums."""
    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    r = random.Random(11)
    n, M = 5000, 3
    base = [spec.gen.mul(r.randrange(1, spec.r)) for _ in range(7)]
    base.append(spec.infinity())
    rows = [[r.randrange(spec.r) for _ in range(n)] for _ in range(M)]
    rows[1][:3] = [0, 1, spec.r - 1]
    P = dc.encode_points([base[i % 8] for i in range(n)])
    S = torch.stack([torch.as_tensor(scalars_to_limbs(spec, s), device=dev)
                     for s in rows])
    b5 = K.B5.at(dc.df.L)
    before = b5.launches
    got = dc.decode_points(pp.msm_many(dc, P, S))
    # the reduce's combine, then the one Horner of all M windows
    assert b5.launches - before == 2
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: False)
    assert dc.decode_points(pp.msm_many(dc, P, S)) == got
    for m, s in enumerate(rows):
        want = spec.infinity()
        for i, b in enumerate(base):
            want = want.add(b.mul(sum(s[i::8]) % spec.r))
        assert got[m] == want


def test_cell_proofs_match_plain_route_and_host(dev, monkeypatch):
    """All 128 cell proofs of a random blob on the card: cells 0, 64 and
    127 equal the same cells by the plain MSM route on the card and the
    host path's `compute_cell_proof`, and one verifies by the pairing."""
    from davinci_tpu_torch.blobs import cells
    from davinci_tpu_torch.blobs.kzg import blob_to_commitment

    rng = random.Random(0x7594)
    blob = cells.Blob([rng.randrange(F.BLS12_381_R)
                       for _ in range(cells.BLOB_CELLS)])
    ids = [0, 64, 127]
    proofs = cells.compute_cell_proofs_device(blob, device=dev)
    assert len(proofs) == cells.CELLS_PER_BLOB
    got = [proofs[i] for i in ids]
    assert got == [cells.compute_cell_proof(blob, i) for i in ids]
    cell = cells.compute_cells(blob)[64]
    assert cells.verify_cell_proof(blob_to_commitment(blob), 64, cell, got[1])
    monkeypatch.setattr(pp, "_use_pipeline", lambda device: False)
    assert cells.compute_cell_proofs_device(blob, ids, device=dev) == got


# -- B6, the Montgomery product ------------------------------------------------

B6_FIELDS = ["bn254_fr", "bn254_fp", "bls12_377_fr", "bls12_381_fr",
             "bls12_377_fp", "bls12_381_fp", "bw6_761_fp"]


@pytest.mark.parametrize("name", B6_FIELDS)
def test_mont_mul_matches_plain(dev, name):
    """Random elements, 0, 1, p - 1 and raw values up to R - 1 (to_mont's
    input, on either side); a broadcast operand; one launch each."""
    spec = getattr(F, name)
    df = get_device_field(spec, dev)
    kernel = K.B6.at(df.L)
    r = random.Random(11)
    p, R = spec.p, 1 << (12 * df.L)
    xs = [r.randrange(p) for _ in range(997)] + [0, 1, p - 1]
    ys = [r.randrange(p) for _ in range(997)] + [p - 1, 0, 1]
    raw = [r.randrange(R) for _ in range(997)] + [R - 1, p, 0]
    a, b = df.encode(xs), df.encode(ys)
    c = torch.as_tensor(  # unreduced limbs
        [[(v >> (12 * j)) & 0xFFF for j in range(df.L)] for v in raw],
        dtype=torch.int32, device=dev)
    for x, y in ((a, b), (c, b), (b, c), (a, b[:1]), (a[:1], c)):
        _equal_once(kernel, lambda: cuda_mul.mont_mul(df, x, y),
                    lambda: cuda_mul.mont_mul_plain(df, x, y))
    assert df.decode(df.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert df.decode(df.to_mont(c)) == [v % p for v in raw]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, (1 << 16) + 5])
@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fp", "bw6_761_fp"])
def test_mont_mul_tiles(dev, name, n):
    """B6's block tiles of 128 rows (64 at L = 64): counts that end inside
    a block, a
    broadcast row on either side (as (1, L) and as (L,)), repeating rows,
    a raw operand on either side and a view at an odd row offset."""
    spec = getattr(F, name)
    df = get_device_field(spec, dev)
    kernel = K.B6.at(df.L)
    L = df.L
    g = _gen(18)
    top = spec.p.bit_length() - 12 * (L - 1) - 1  # limbs of a value < p
    limbs = torch.randint(0, 1 << 12, (n + 1, L), generator=g)
    limbs[:, -1] %= 1 << max(top, 0)
    a_wide = limbs.to(torch.int32).to(dev)
    a = a_wide[1:]  # an odd row offset: 4 L bytes past the allocation
    b = torch.randint(0, 1 << 12, (n, L), generator=g)
    b[:, -1] %= 1 << max(top, 0)
    b = b.to(torch.int32).to(dev)
    raw = torch.randint(0, 1 << 12, (n, L), generator=g).to(torch.int32)
    raw = raw.to(dev)  # any value below R
    rep = torch.stack([a, b, a]).contiguous()  # (3, n, L) against (n, L)
    cases = [(a, b), (a, b[:1]), (a[:1], b), (a, b[0]), (b[0], a),
             (raw, b), (b, raw), (rep, b), (b, rep), (raw[:1], b)]
    for x, y in cases:
        _equal_once(kernel, lambda: cuda_mul.mont_mul(df, x, y),
                    lambda: cuda_mul.mont_mul_plain(df, x, y))


@pytest.mark.parametrize("first", [True, False])
def test_mont_mul_empty_operand_launches_nothing(dev, first):
    """(0, L) rows against a (1, L) row, on either side: an empty (0, L)
    product and no launch."""
    df = get_device_field(F.bn254_fr, dev)
    a = df.one_mont[None].repeat(2, 1)
    x, y = (a[:0], a[:1]) if first else (a[:1], a[:0])
    before = K.B6.launches
    out = cuda_mul.mont_mul(df, x, y)
    torch.cuda.synchronize()
    assert out.shape == (0, df.L) and out.is_cuda
    assert K.B6.launches == before


def test_mont_mul_refuses_unsupported_fields(dev):
    df = get_device_field(F.secp256k1_fp, dev)
    a = df.zero[None]
    with pytest.raises(ValueError):
        df.mul(a, a)


# -- B8, the point-add experiment's designs of the G1 add -------------------------


@pytest.mark.parametrize("variant", addk_exp.KERNELS)
def test_addk_matches_plain_and_b1(dev, variant):
    """The experiment's points, the edge cases and points rescaled near
    p - 1 (the lazy variant's largest inputs), in the (L, n) layout."""
    dc = get_device_curve(C.bn254_g1, dev)
    pts, a, b = addk_exp.experiment_points(dc, 1024)
    ha, hb = addk_exp.hard_cases(dc, pts)
    rows_a = tuple(torch.cat(c) for c in zip(a, ha))
    rows_b = tuple(torch.cat(c) for c in zip(b, hb))
    A = tuple(x.T.contiguous() for x in rows_a)
    B = tuple(x.T.contiguous() for x in rows_b)
    _equal_once(K.B8[variant], lambda: addk_exp.add_2d(dc, variant, *A, *B),
                lambda: addk_exp.add_2d_plain(dc, variant, *A, *B))
    if variant != "addonly":
        got = addk_exp.add_2d(dc, variant, *A, *B)
        for g, w in zip(got, dc.add(rows_a, rows_b)):
            assert torch.equal(g, w.T)


def test_addk_refuses_other_curves_and_device_mixes(dev):
    bls = get_device_curve(C.bls381_g1, dev)
    P = tuple(x.T.contiguous() for x in bls.identity((4,)))
    with pytest.raises(ValueError):
        addk_exp.add_2d(bls, "v2d", *P, *P)
    dc = get_device_curve(C.bn254_g1, dev)
    Q = tuple(x.T.contiguous() for x in dc.identity((4,)))
    with pytest.raises(ValueError):
        addk_exp.add_2d(dc, "v2d", *Q[:2], Q[2].cpu(), *Q)


def test_addk_entry_point(dev, capsys):
    assert addk_exp.main(["1024", *addk_exp.KERNELS], device=dev) == 0
    assert len(capsys.readouterr().out.splitlines()) == 4


def test_toy_fields_raise_on_the_card(dev):
    """The toy BLS12 of the recursion tests has no kernel build: its Fr
    (L = 5) is refused at construction and its Fp (L = 8) at its first
    product; nothing falls back to the plain product."""
    from davinci_tpu_torch.circuits.toycurve import toy_bls12
    from davinci_tpu_torch.ff.mod import DeviceField

    t = toy_bls12()
    with pytest.raises(ValueError):
        DeviceField(t["fr_spec"], dev)
    df = DeviceField(t["fp_spec"], dev)
    with pytest.raises(ValueError):
        df.mul(df.one_mont, df.one_mont)
