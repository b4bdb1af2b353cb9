"""The bucket-scan MSM path's kernels and the PyTorch around them.
Counterpart of `davinci_tpu/msm/bucket_kernel.py`.

Hand-written CUDA kernels (`csrc/bucket.cu`, built for L = 22 (BN254)
and L = 32 (BLS12-381/377)), each with its plain PyTorch version beside
its wrapper:

  * B2 `_bucket_scan`: walks each lane of the sorted, column-major point
    stream, folding a point into the running accumulator with the mixed
    addition while the bucket stays the same, and emits the accumulator at
    every position: (rows, NL, 3L).
  * B3 `bucket_reduce_kernel`: per-lane reduce partials A_c = sum_k S_kC+c
    and B_c = sum_k k S_kC+c of (L, Wt, NB) bucket arrays, read in place.
  * B4 `suffix_reduce_kernel`: A = sum_k s_k, B = sum_k k s_k over the
    leading axis of (K, 3L, M), split into chunks walked in parallel.
  * B5 `horner_kernel`: sum_w 2^(wbits w) S_w, MSB first; on G2 rows
    `horner_g2_kernel` (the fused route's window combine).

The TPU carries each accumulator across sequential grid steps in VMEM;
here a loop walks the sequential axis: B4 gives a chunk of a lane one
CUDA thread, B2 and B5 six threads of a warp that share each add, B3 two
such groups (its two sums side by side).
A wrapper runs the plain version on CPU tensors only; on CUDA tensors it
launches its kernel or raises.  Both give canonical limbs, so they agree
limb for limb (B4's kernel with `_suffix_reduce_split_plain`, its CPU
route the reference's order).

The inputs are affine (z in {0, one}) and their 12-bit Montgomery limbs
are repacked into dense base-2^16 planes, x in the low and y in the high
half of an int32 (`pack_points`).  Infinities are redirected to the sink
key; after the scan, each bucket's mid-lane tail piece is gathered from
the stream at a position computed from the sorted keys alone, and runs
that reach a lane's last row are left to the caller's leftover merge
(`pippenger._merge_leftovers_t`).
"""

from __future__ import annotations

import torch

from davinci_tpu_torch.ec.cuda_add import _consts, rcb15_mixed_plain, rcb15_plain
from davinci_tpu_torch.kernels import B2, B3, B4, B5, B5G2, check_tensors

REDUCE_C = 256  # lanes per window chunk of the bucket reduce (K = NB / C rows)


def _planes(L: int) -> int:
    return (12 * L + 15) // 16


def _require(kernel, cond, what):
    if not cond:
        raise ValueError(f"{kernel.name}: {what}")


def _cuda_curve(kernel, curve, tensors, coord_ndim=1):
    """Checks before a launch: a curve of the kernel's group (G1, or G2
    for coord_ndim 2) with a build of the kernel for its limb count
    (L = 22, 32 or 64; the Consts array raises otherwise) and contiguous
    operands.  Returns that build and the Consts array."""
    _require(kernel, curve.ops.coord_ndim == coord_ndim,
             "built for G2 (Fp2) only" if coord_ndim == 2
             else "built for G1 (Fp) only")
    _require(kernel, all(t.is_contiguous() for t in tensors),
             "operands must be contiguous")
    return kernel.at(curve.df.L), _consts(curve)


# -- plane packing --------------------------------------------------------


def pack_points(curve, xs, ys, zs):
    """(n, L) coords -> ((n, LP) packed 16-bit planes, (n,) is_inf).

    Plane j carries bits [16j, 16j + 16) of x in its low and of y in its
    high half (y can set the int32 sign bit); a 16-bit window over 12-bit
    limbs spans at most two limbs.  Depends only on the points, so the
    proving key's bases pack once (`EncodedBases.device_packed`)."""
    L = xs.shape[-1]

    def pack16(a):
        a = a.to(torch.int64)
        planes = []
        for j in range(_planes(L)):
            q, s = divmod(16 * j, 12)
            v = a[:, q] >> s
            if q + 1 < L:
                v = v | (a[:, q + 1] << (12 - s))
            planes.append(v & 0xFFFF)
        return torch.stack(planes, dim=1)

    # built in int64, narrowed to the reference's int32 bit patterns
    packed = (pack16(xs) | (pack16(ys) << 16)).to(torch.int32)
    return packed, (zs == 0).all(-1)


def _unpack12(u, L: int):
    """(..., LP, nl) 16-bit planes -> (..., L, nl) 12-bit limbs."""
    LP = u.shape[-2]
    out = []
    for i in range(L):
        b, t = divmod(12 * i, 16)
        v = u[..., b, :] >> t
        if t > 4 and b + 1 < LP:  # the 12-bit limb spills into plane b+1
            v = v | (u[..., b + 1, :] << (16 - t))
        out.append(v & 0xFFF)
    return torch.stack(out, dim=-2)


# -- B2: the bucket scan ------------------------------------------------------


def _bucket_scan(curve, pts_arr, keys_arr, signed=False):
    """pts_arr: (rows, LP, NL) sorted column-major packed affine points;
    keys_arr: (rows, NL) sorted keys (signed: 2 * bucket + sign).
    Returns the projective running accumulator stream (rows, NL, 3L).
    The kernel multiplies by 3b with additions (and a negation where 3b
    is negative, BW6-761 G1's -3): a curve whose 3b is neither small nor
    the negative of a small integer (`cuda_add.b3_signed_small`) is
    refused."""
    device = check_tensors(B2, (pts_arr, keys_arr))
    rows, LP, nl = pts_arr.shape
    L = curve.df.L
    _require(B2, LP == _planes(L), f"{LP} planes for L={L}")
    _require(B2, tuple(keys_arr.shape) == (rows, nl),
             f"keys shaped {tuple(keys_arr.shape)}")
    if device.type == "cpu":
        return _bucket_scan_plain(curve, pts_arr, keys_arr, signed)
    kernel, consts = _cuda_curve(B2, curve, (pts_arr, keys_arr))
    _require(B2, consts[len(consts) - 2] != 0,
             f"3b of {curve.df.spec.name}'s curve is not a small integer"
             f" or the negative of one")
    out = torch.empty((rows, nl, 3 * L), dtype=torch.int32, device=device)
    if out.numel():
        kernel.launch(device, (pts_arr, keys_arr, out), consts,
                      (rows, nl, int(signed)))
    return out


def _bucket_scan_plain(curve, pts_arr, keys_arr, signed=False):
    rows, _, nl = pts_arr.shape
    L = curve.df.L
    X = _unpack12(pts_arr & 0xFFFF, L).transpose(1, 2)  # (rows, nl, L)
    Y = _unpack12((pts_arr >> 16) & 0xFFFF, L).transpose(1, 2)
    bucket = (keys_arr >> 1) if signed else keys_arr
    if signed:  # sign bit 0 of the key: -P = (x, -y)
        Y = torch.where((keys_arr & 1).bool()[..., None], curve.ops.neg(Y), Y)
    one = curve.ops.one_mont.expand(nl, L)
    out = torch.empty((rows, nl, 3 * L), dtype=torch.int32,
                      device=pts_arr.device)
    acc = (X[0], Y[0], one)
    out[0] = torch.cat(acc, dim=-1)
    for r in range(1, rows):
        merged = rcb15_mixed_plain(curve, acc, (X[r], Y[r]))
        same = (bucket[r] == bucket[r - 1])[:, None]
        acc = tuple(torch.where(same, m, f)
                    for m, f in zip(merged, (X[r], Y[r], one)))
        out[r] = torch.cat(acc, dim=-1)
    return out


def bucket_accumulate_kernel(curve, xs, ys, zs, keys_all, cols: int,
                             nbuckets: int, signed: bool = False):
    """Bucket sums for a tile of windows through the scan kernel; see
    `bucket_accumulate_packed`."""
    packed, is_inf = pack_points(curve, xs, ys, zs)
    return bucket_accumulate_packed(curve, packed, is_inf, keys_all, cols,
                                    nbuckets, signed)


def bucket_accumulate_packed(curve, packed, is_inf, keys_all, cols: int,
                             nbuckets: int, signed: bool = False):
    """Bucket sums over pre-packed planes (see pack_points).

    keys_all: (Wt, n) bucket keys: plain bucket indices with padding at
    nbuckets, or (signed) the sort keys 2 * bucket + sign of
    `pippenger._signed_sort_keys` with padding and zero digits at
    2 * nbuckets.  Infinity points are redirected to the sink here.
    Returns transposed bucket arrays (L, Wt, nbuckets + 2) x3 (slot
    nbuckets is the sink, nbuckets + 1 scratch) and the lane-final
    leftovers (L, Wt, cols) x3 with their bucket-slot keys (Wt, cols)."""
    Wt, n = keys_all.shape
    L = curve.df.L
    dev = keys_all.device
    if packed.shape[-1] != _planes(L):
        raise ValueError(f"{packed.shape[-1]} planes for L={L}")
    if n % cols:
        raise ValueError(f"n={n} is not a multiple of cols={cols}")
    rows = n // cols
    nl = Wt * cols
    sink = 2 * nbuckets if signed else nbuckets

    keys_all = torch.where(is_inf[None, :], sink, keys_all)
    # stable, as the reference's argsort: equal keys keep their order,
    # which fixes the projective limbs of the stream
    k, order = torch.sort(keys_all, dim=1, stable=True)
    k = k.contiguous()
    # column-major lanes: sorted position s -> (lane s // rows, row s % rows)
    order2 = order.reshape(Wt, cols, rows).permute(2, 0, 1).reshape(rows, nl)
    pts_arr = packed[order2].transpose(1, 2).contiguous()  # (rows, LP, nl)
    keys_arr = (k.reshape(Wt, cols, rows).permute(2, 0, 1)
                .reshape(rows, nl).contiguous())
    del order, order2
    acc_stream = _bucket_scan(curve, pts_arr, keys_arr, signed)
    del pts_arr

    # --- bucket tail-piece positions from the sorted keys alone -----------
    # ends[w, b] = # keys <= b (signed: # elements with bucket <= b, i.e.
    # # keys <= 2b + 1); a bucket's mid-lane tail sits at ends - 1
    b_iota = torch.arange(nbuckets, dtype=k.dtype, device=dev)
    b_query = (2 * b_iota + 1) if signed else b_iota
    ends = torch.searchsorted(k, b_query.expand(Wt, nbuckets).contiguous(),
                              right=True)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    use = (ends > starts) & (ends % rows != 0)
    last = (ends - 1).clamp(min=0)
    w_iota = torch.arange(Wt, device=dev)[:, None]
    flat_idx = (last % rows) * nl + w_iota * cols + last // rows
    vals = acc_stream.reshape(rows * nl, 3 * L)[flat_idx.reshape(-1)]
    vals_t = vals.reshape(Wt, nbuckets, 3 * L).permute(2, 0, 1)  # (3L, Wt, NB)

    one = curve.ops.one_mont
    zero = torch.zeros_like(one)
    ident_t = torch.cat([zero, one, zero])[:, None, None]
    vals_t = torch.where(use[None], vals_t, ident_t)
    # the sink and scratch slots hold the identity
    buckets_cat = torch.cat([vals_t, ident_t.expand(3 * L, Wt, 2)], dim=2)
    buckets = tuple(buckets_cat[c * L:(c + 1) * L] for c in range(3))

    # --- lane-final leftovers: the stream's last row, transposed ----------
    fin = acc_stream[rows - 1].T.reshape(3 * L, Wt, cols)
    acc = tuple(fin[c * L:(c + 1) * L] for c in range(3))
    acc_key = keys_arr[rows - 1].reshape(Wt, cols)
    if signed:
        acc_key = acc_key >> 1  # bucket-slot space for the leftover merge
    return buckets, acc, acc_key


# -- B3: the bucket reduce ----------------------------------------------------


def bucket_reduce_kernel(curve, buckets):
    """Per-lane reduce partials of (L, Wt, NB) x3 bucket arrays (sink and
    scratch slots stripped; NB a power of two).  With C = REDUCE_C (or NB
    if it does not divide NB) and K = NB / C, returns (A, B), each
    (L, Wt, C) x3:  A_c = sum_k S_{kC+c},  B_c = sum_k k S_{kC+c},  so
    T_w = C sum_c B_c + sum_c c A_c.

    The three arrays may be views with one set of strides and contiguous
    slots, such as the first NB slots of the MSM's (L, Wt, NB + 2)
    buckets: the kernel reads them in place."""
    device = check_tensors(B3, buckets)
    L, Wt, NB = buckets[0].shape
    _require(B3, L == curve.df.L and NB & (NB - 1) == 0,
             f"buckets shaped {tuple(buckets[0].shape)}")
    _require(B3, all(b.shape == buckets[0].shape for b in buckets),
             "coordinates differ in shape")
    C = REDUCE_C if NB % REDUCE_C == 0 else NB
    if device.type == "cpu":
        return _bucket_reduce_plain(curve, buckets, C)
    strides = buckets[0].stride()
    _require(B3, all(b.stride() == strides for b in buckets)
             and strides[2] == 1, "buckets need one set of strides and "
             "contiguous slots")
    kernel, consts = _cuda_curve(B3, curve, ())
    outs = [torch.empty((L, Wt, C), dtype=torch.int32, device=device)
            for _ in range(6)]
    if Wt:
        kernel.launch(device, (*buckets, *outs), consts,
                      (Wt, NB, C, strides[1], strides[0]))
    return tuple(outs[:3]), tuple(outs[3:])


def _bucket_reduce_plain(curve, buckets, C: int):
    L, Wt, NB = buckets[0].shape
    K = NB // C
    # (L, Wt, K, C) -> (K, Wt, C, L): the limb axis last for rcb15_plain
    S = tuple(b.reshape(L, Wt, K, C).permute(2, 1, 3, 0) for b in buckets)
    run = bacc = curve.identity((Wt, C))
    for k in reversed(range(K)):
        run = rcb15_plain(curve, run, tuple(s[k] for s in S))
        if k:
            bacc = rcb15_plain(curve, bacc, run)
    back = lambda p: tuple(a.permute(2, 0, 1).contiguous() for a in p)
    return back(run), back(bacc)


# -- B4: the suffix reduce ----------------------------------------------------

SUFFIX_MAX_CHUNKS = 128  # B4's chunks per lane: one block holds them all


def suffix_chunk(K: int) -> int:
    """Rows per chunk of B4's split walk: the least power of two at or
    above sqrt(K), raised until at most SUFFIX_MAX_CHUNKS chunks remain
    (K = 256: 16 chunks of 16)."""
    T = 1 << ((K - 1).bit_length() + 1) // 2
    while -(-K // T) > SUFFIX_MAX_CHUNKS:
        T <<= 1
    return T


def suffix_reduce_kernel(curve, s):
    """s: (K, 3L, M) int32 point columns (X limbs, then Y, then Z).
    Returns (A, B), each (3L, M): A = sum_k s_k, B = sum_k k s_k.

    On CUDA, B4 walks chunks of T = suffix_chunk(K) rows on parallel
    threads and combines their sums: the order of
    `_suffix_reduce_split_plain`.  On CPU, `_suffix_reduce_plain`: the
    reference's one walk.  The two give the same points in different
    projective representatives."""
    device = check_tensors(B4, (s,))
    K, L3, M = s.shape
    _require(B4, L3 == 3 * curve.df.L and K > 0, f"s shaped {tuple(s.shape)}")
    if device.type == "cpu":
        return _suffix_reduce_plain(curve, s)
    kernel, consts = _cuda_curve(B4, curve, (s,))
    A = torch.empty((L3, M), dtype=torch.int32, device=device)
    B = torch.empty_like(A)
    if M:
        kernel.launch(device, (s, A, B), consts, (K, M, suffix_chunk(K)))
    return A, B


def _columns(p):
    """(X, Y, Z), each (..., M, L) -> (..., 3L, M) point columns."""
    return torch.cat([a.transpose(-1, -2) for a in p], dim=-2).contiguous()


def _suffix_reduce_plain(curve, s):
    K, L3, M = s.shape
    L = L3 // 3
    S = s.reshape(K, 3, L, M).permute(1, 0, 3, 2)  # (3, K, M, L)
    run = bacc = curve.identity((M,))
    for k in reversed(range(K)):
        run = rcb15_plain(curve, run, tuple(S[:, k]))
        if k:
            bacc = rcb15_plain(curve, bacc, run)
    return _columns(run), _columns(bacc)


def _suffix_reduce_split_plain(curve, s, T: int):
    """B4's order: the rows in P = ceil(K / T) chunks of T (the last
    padded with the identity); per chunk c the suffix walk gives A_c =
    sum_j s_{cT+j} and B_c = sum_j j s_{cT+j}; the same walk over the A_c
    gives A and W = sum_c c A_c; W is doubled log2 T times; S = sum_c B_c
    from the identity, c descending; B = W + S."""
    K, L3, M = s.shape
    L = L3 // 3
    P = -(-K // T)
    if P * T != K:
        pad = _columns(curve.identity((M,)))
        s = torch.cat([s, pad.expand(P * T - K, L3, M)])
    S = s.reshape(P, T, 3, L, M).permute(2, 1, 0, 4, 3)  # (3, T, P, M, L)
    run = bacc = curve.identity((P, M))
    for j in reversed(range(T)):
        run = rcb15_plain(curve, run, tuple(S[:, j]))
        if j:
            bacc = rcb15_plain(curve, bacc, run)
    A = W = total = curve.identity((M,))
    for c in reversed(range(P)):
        A = rcb15_plain(curve, A, tuple(a[c] for a in run))
        if c:
            W = rcb15_plain(curve, W, A)
        total = rcb15_plain(curve, total, tuple(b[c] for b in bacc))
    for _ in range(T.bit_length() - 1):
        W = rcb15_plain(curve, W, W)
    return _columns(A), _columns(rcb15_plain(curve, W, total))


# -- B5: Horner ---------------------------------------------------------------


def horner_kernel(curve, sums, W: int, wbits: int):
    """Window combine on transposed sums: (L, W*B) x3 window-major (window
    w, batch b at column w*B + b) -> (L, B) x3 = sum_w 2^(wbits w) S_w,
    MSB first: wbits doublings and one add per lower window."""
    device = check_tensors(B5, sums)
    L, WB = sums[0].shape
    _require(B5, L == curve.df.L and W > 0 and WB % W == 0,
             f"sums shaped {tuple(sums[0].shape)} for W={W}")
    _require(B5, all(s.shape == sums[0].shape for s in sums),
             "coordinates differ in shape")
    if device.type == "cpu":
        return _horner_plain(curve, sums, W, wbits)
    kernel, consts = _cuda_curve(B5, curve, sums)
    B = WB // W
    outs = tuple(torch.empty((L, B), dtype=torch.int32, device=device)
                 for _ in range(3))
    if B:
        kernel.launch(device, (*sums, *outs), consts, (W, B, wbits))
    return outs


def _horner_plain(curve, sums, W: int, wbits: int):
    L, WB = sums[0].shape
    S = tuple(a.reshape(L, W, WB // W).permute(1, 2, 0) for a in sums)
    tot = tuple(a[W - 1] for a in S)
    for w in reversed(range(W - 1)):
        for _ in range(wbits):
            tot = rcb15_plain(curve, tot, tot)
        tot = rcb15_plain(curve, tot, tuple(a[w] for a in S))
    return tuple(a.T.contiguous() for a in tot)


def horner_g2_kernel(curve, sums, wbits: int):
    """Window combine on G2 rows: (W, B, 2, L) x3 window-major, contiguous
    -> (B, 2, L) x3 = sum_w 2^(wbits w) S_w, MSB first: wbits doublings
    and one add per lower window, the order of the reference's
    `pippenger._horner`.  One launch on CUDA."""
    device = check_tensors(B5G2, sums)
    W, B = sums[0].shape[:2]
    L = curve.df.L
    _require(B5G2, tuple(sums[0].shape[2:]) == (2, L) and W > 0,
             f"sums shaped {tuple(sums[0].shape)}")
    _require(B5G2, all(s.shape == sums[0].shape for s in sums),
             "coordinates differ in shape")
    if device.type == "cpu":
        return _horner_rows_plain(curve, sums, wbits)
    kernel, consts = _cuda_curve(B5G2, curve, sums, coord_ndim=2)
    outs = tuple(torch.empty((B, 2, L), dtype=torch.int32, device=device)
                 for _ in range(3))
    if B:
        kernel.launch(device, (*sums, *outs), consts, (W, B, wbits))
    return outs


def _horner_rows_plain(curve, sums, wbits: int):
    """The plain window combine on rows (W, ...) x3 -> (...) x3."""
    W = sums[0].shape[0]
    tot = tuple(a[W - 1] for a in sums)
    for w in reversed(range(W - 1)):
        for _ in range(wbits):
            tot = rcb15_plain(curve, tot, tot)
        tot = rcb15_plain(curve, tot, tuple(a[w] for a in sums))
    return tot
