"""Multi-scalar multiplication (Pippenger) as a batched bucket pipeline.
Counterpart of `davinci_tpu/msm/pippenger.py`.  `msm` picks its route as
the reference does:

  * CPU tensors: the plain double-and-add `_msm_reference`, as the
    reference does on its CPU backend.
  * G1 on CUDA, `_msm_scan`: the reference's default (TPU) path.  Scalars
    are recoded to signed digits in [-2048, 2048] (half the buckets), the
    points packed into 16-bit planes, and kernels B2-B5 of
    `bucket_kernel` do the bucket scan, the bucket reduce, the cross-lane
    suffix reduce and Horner; the leftover merge is point adds (B1) on
    the transposed (L, ...) layout, B1's own, and the combine's doubling
    chain one more launch of B5.
  * G2 on CUDA, `_msm_fused`: the scan composition the reference takes
    with its kernels off (`pippenger.py:742-751`), on `DeviceCurve.add`
    (B7).  Window size == LIMB_BITS (12): the j-th raw scalar limb is
    the bucket of window j; all windows at once; points sorted by bucket
    (stable sort, so the streams match the reference's), laid out
    column-major (rows, COLS); a Python loop walks the rows and writes
    finished segments into the bucket array; runs that cross columns
    merge by a log-depth segmented suffix sum; sum_b b*S_b by a
    Hillis-Steele suffix scan plus a tree sum; Horner last (on CUDA one
    launch of B5's G2 build).

`msm_many` runs M MSMs of one G1 point set on the card as M*W rows of
one scan path (the EIP-7594 cell proofs' 128 commitments over the blob
setup), and one `msm` per m otherwise; `msm_host_input` wraps `msm` for
host points and int scalars.  `sharded_msm` splits one MSM over the
ranks of a mesh axis (`parallel/mesh.py`): each rank takes its block of
the points through the same routes, the bucket arrays (or, plain, the
partial points) are all-gathered and folded with point adds.

The tests drive `_msm_fused` and `_msm_scan` directly on the CPU, where
every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from davinci_tpu_torch.ec import cuda_add
from davinci_tpu_torch.fields import LIMB_BITS
from davinci_tpu_torch.msm import bucket_kernel
from davinci_tpu_torch.parallel.mesh import (
    all_gather_rows,
    axis_rank,
    axis_size,
)

WINDOW_BITS = LIMB_BITS
NBUCKETS = 1 << WINDOW_BITS  # bucket 0 contributes nothing (b * S_0, b=0)
# signed digits in [-2048, 2048] halve the bucket count; the sign rides
# bit 0 of the sort key and the scan kernel negates y on the fly
SIGNED_NBUCKETS = NBUCKETS // 2
COLS = 2048  # scan width per window: batched point adds per row
# cap on the sorted-point working set (elements of W_tile * n)
MAX_TILE_ELEMS = 1 << 23


def _signed_sort_keys(limbs):
    """(n, W) raw base-2^12 digits -> (n, W) int32 signed-scheme sort keys.

    Recode d_j to [-2048, 2047] (the top window unsigned), then key =
    (|d| - 1) * 2 + sign for d != 0; zero digits go to the sink key
    2 * SIGNED_NBUCKETS (== NBUCKETS, the padding key).  Bucket slot i
    holds the sum of (sign-applied) points with |digit| == i + 1, so the
    reduce weighs slot i by i + 1 (`shifted`).

    Contract: every scalar is below 2^(12W - 1), so the top raw digit is
    at most 2047 and the top window absorbs the last carry (checked in
    scalars_to_limbs)."""
    n, W = limbs.shape
    snb = SIGNED_NBUCKETS
    carry = torch.zeros((n,), dtype=torch.int32, device=limbs.device)
    ds = []
    for j in range(W):
        v = limbs[:, j] + carry
        if j == W - 1:
            ds.append(v)
            break
        neg = (v >= snb).to(torch.int32)
        ds.append(v - neg * NBUCKETS)
        carry = neg
    D = torch.stack(ds, dim=1)  # signed digits, |D| <= 2048
    mag = D.abs()
    keys = (mag - 1) * 2 + (D < 0).to(torch.int32)
    return torch.where(mag == 0, 2 * snb, keys).to(torch.int32)


def _flat_scatter_set(buckets, w_idx, b_idx, vals, nb):
    """Scatter into (W, nb+2, ...) bucket arrays IN PLACE via flat
    indices.  The reference's mode="drop" scatter drops out-of-range
    indices, where torch would raise: they are masked onto the window's
    scratch slot nb+1, which is never read."""
    W = buckets[0].shape[0]
    keep = (b_idx >= 0) & (b_idx < nb + 2)
    flat_idx = (w_idx * (nb + 2) + torch.where(keep, b_idx, nb + 1)).reshape(-1)
    for buf, v in zip(buckets, vals):
        trailing = buf.shape[2:]
        flat = buf.view((W * (nb + 2),) + trailing)
        flat[flat_idx] = v.reshape((-1,) + trailing)


def _flat_gather(buckets, w_idx, b_idx, nb):
    W = buckets[0].shape[0]
    flat_idx = w_idx * (nb + 2) + b_idx
    return tuple(
        b.reshape((W * (nb + 2),) + b.shape[2:])[flat_idx.reshape(-1)].reshape(
            flat_idx.shape + b.shape[2:]
        )
        for b in buckets
    )


def _bucket_accumulate_fused(curve, xs, ys, zs, keys_all):
    """Bucket sums for a tile of windows at once.

    xs/ys/zs: (n, ...) point coords; keys_all: (Wt, n) bucket indices.
    Returns bucket arrays (Wt, NBUCKETS+2, ...): slot NBUCKETS is the
    padding sink, slot NBUCKETS+1 the scratch target of non-emissions.
    """
    Wt, n = keys_all.shape
    trailing = xs.shape[1:]
    if n % COLS:
        raise ValueError(f"n={n} is not a multiple of COLS={COLS}")
    rows = n // COLS

    order = torch.sort(keys_all, dim=1, stable=True).indices  # (Wt, n)
    k = torch.gather(keys_all, 1, order)
    # one gather of the concatenated coordinates instead of three
    pts_cat = torch.cat([xs, ys, zs], dim=-1)
    sorted_cat = pts_cat[order]  # (Wt, n, ..., 3*L)
    third = xs.shape[-1]
    pts = (
        sorted_cat[..., :third],
        sorted_cat[..., third : 2 * third],
        sorted_cat[..., 2 * third :],
    )
    del sorted_cat

    # column-major per window: (rows, Wt, COLS, ...)
    k2 = k.reshape(Wt, COLS, rows).movedim(2, 0)
    p2 = tuple(
        a.reshape((Wt, COLS, rows) + trailing).movedim(2, 0).contiguous()
        for a in pts
    )

    buckets = curve.identity((Wt, NBUCKETS + 2))
    w_iota = torch.arange(Wt, device=keys_all.device)[:, None]
    acc = tuple(a[0] for a in p2)
    acc_key = k2[0]
    for r in range(1, rows):
        key_r = k2[r]
        pt_r = tuple(a[r] for a in p2)
        same = key_r == acc_key
        merged = curve.add(acc, pt_r)
        # the NB+1 scratch slot absorbs all "no emission" writes
        emit_idx = torch.where(same, NBUCKETS + 1, acc_key)
        _flat_scatter_set(buckets, w_iota, emit_idx, acc, NBUCKETS)
        acc = curve.select(same, merged, pt_r)
        acc_key = key_r
    return _merge_leftovers(curve, buckets, acc, acc_key)


def _merge_leftovers(curve, buckets, acc, acc_key):
    """Fold per-lane final segments (runs that reach their lane's last row)
    into the bucket arrays: a log-depth segmented suffix sum along the lane
    axis groups same-key lane tails, then one gather+add+scatter merges
    each group's total into its bucket.

    buckets: (Wt, NBUCKETS+2, ...) x3; acc: (Wt, cols, ...) x3 lane-final
    accumulators; acc_key: (Wt, cols) lane-final keys (non-decreasing)."""
    Wt, cols = acc_key.shape
    dev = acc_key.device
    w_iota = torch.arange(Wt, device=dev)[:, None]
    keys_l = acc_key
    col_iota = torch.arange(cols, device=dev)
    ident_cols = curve.identity((Wt, cols))

    s = acc
    for i in range(cols.bit_length() - 1):
        stride = 1 << i
        valid = col_iota < (cols - stride)
        pk = torch.where(valid, torch.roll(keys_l, -stride, dims=1), -1)
        ps = curve.select(
            valid.expand(Wt, cols),
            tuple(torch.roll(a, -stride, dims=1) for a in s),
            ident_cols,
        )
        same = keys_l == pk
        s = curve.select(same, curve.add(s, ps), s)

    start = torch.cat(
        [torch.ones((Wt, 1), dtype=torch.bool, device=dev),
         keys_l[:, 1:] != keys_l[:, :-1]], dim=1
    )
    cur = _flat_gather(buckets, w_iota, keys_l, NBUCKETS)
    merged = curve.add(cur, s)
    idx = torch.where(start, keys_l, NBUCKETS + 1)
    _flat_scatter_set(buckets, w_iota, idx, merged, NBUCKETS)
    return buckets


def _bucket_reduce_fused(curve, buckets):
    """sum_b b*S_b per window over (Wt, NBUCKETS+2, ...) buckets
    -> (Wt, ...) points.

    sum_b b*S_b == sum_{b>=1} suffix(b) with suffix(b) = sum_{k>=b} S_k:
    a Hillis-Steele suffix scan (log2(NB) full-width add passes) then a
    log-depth tree sum."""
    Wt = buckets[0].shape[0]
    dev = buckets[0].device
    acc = tuple(a[:, :NBUCKETS] for a in buckets)
    b_iota = torch.arange(NBUCKETS, device=dev)
    ident = curve.identity((Wt, NBUCKETS))

    nbits = NBUCKETS.bit_length() - 1  # == WINDOW_BITS; tests shrink NBUCKETS
    for i in range(nbits):
        stride = 1 << i
        valid = (b_iota < (NBUCKETS - stride)).expand(Wt, NBUCKETS)
        shifted = curve.select(
            valid, tuple(torch.roll(x, -stride, dims=1) for x in acc), ident
        )
        acc = curve.add(acc, shifted)
    # drop suffix(0) (it would weight bucket 0 once): mask slot 0
    acc = curve.select((b_iota >= 1).expand(Wt, NBUCKETS), acc, ident)

    for i in range(nbits):
        s = NBUCKETS >> 1 >> i
        acc = curve.add(acc, tuple(torch.roll(x, -s, dims=1) for x in acc))
    return tuple(a[:, 0] for a in acc)


def _window_tile(n: int, W: int) -> int:
    wt = max(1, MAX_TILE_ELEMS // max(n, 1))
    return min(W, wt)


def _horner(curve, sums, W):
    """Combine window sums: total = sum_j 2^(12 j) * S_j (Horner, MSB down).
    sums: tuple of (W, ...) tensors.  One launch of B5: G2's (W, ..., 2, L)
    go to its G2 build as rows, G1's (W, ..., L) through a transpose."""
    nd = curve.ops.coord_ndim
    batch, coord = sums[0].shape[1:-nd], sums[0].shape[-nd:]
    rows = tuple(s.reshape(W, -1, *coord) for s in sums)
    if nd == 2:
        out = bucket_kernel.horner_g2_kernel(curve, rows, WINDOW_BITS)
    else:
        out = _horner_dispatch(curve, tuple(s.reshape(-1, coord[0]).T
                                            for s in rows), W)
        out = tuple(a.T for a in out)
    return tuple(a.reshape(*batch, *coord) for a in out)


# ---------------------------------------------------------------------------
# Transposed (L, ...) layout: the scan path.  Limbs lead, the batch
# (windows x buckets or columns) follows, as in the bucket-scan kernel's
# output and B1's planes.
# ---------------------------------------------------------------------------


def _t_add(curve, p, q):
    """Complete addition on transposed (L, ...) coordinates: B1 on the
    planes as they are on CUDA, the plain add on CPU."""
    return cuda_add.point_add_planes(curve, p, q)


def _t_double(curve, p):
    return _t_add(curve, p, p)


def _t_select(cond, p, q):
    """cond: batch-shaped (no limb axis), right-aligned broadcast against
    the (L, ...batch) coordinates."""
    return tuple(torch.where(cond, a, b) for a, b in zip(p, q))


def _t_identity(curve, shape):
    L = curve.df.L
    one = curve.ops.one_mont.reshape((L,) + (1,) * len(shape))
    x = torch.zeros((L,) + shape, dtype=torch.int32, device=one.device)
    return (x, one.expand((L,) + shape), x)


def _merge_leftovers_t(curve, buckets, acc, acc_key):
    """Fold the lane-final segments into the buckets, transposed: a
    log-depth segmented suffix sum along the lane axis groups same-key
    lane tails, then one gather + add + scatter merges each group's total
    into its bucket.

    buckets: (L, Wt, NB + 2) x3 (the last slot is scratch); acc: (L, Wt,
    cols) x3 lane-final accumulators; acc_key: (Wt, cols) lane-final
    bucket slots (non-decreasing).  Returns new bucket arrays."""
    L, Wt, cols = acc[0].shape
    dev = acc_key.device
    keys_l = acc_key
    col_iota = torch.arange(cols, device=dev)
    ident_cols = _t_identity(curve, (Wt, cols))

    s = acc
    for i in range(max(cols.bit_length() - 1, 0)):
        stride = 1 << i
        valid = col_iota < (cols - stride)
        pk = torch.where(valid, torch.roll(keys_l, -stride, dims=1), -1)
        ps = _t_select(valid, tuple(torch.roll(a, -stride, dims=2) for a in s),
                       ident_cols)
        s = _t_select(keys_l == pk, _t_add(curve, s, ps), s)

    start = torch.cat([torch.ones((Wt, 1), dtype=torch.bool, device=dev),
                       keys_l[:, 1:] != keys_l[:, :-1]], dim=1)
    nbp = buckets[0].shape[2]
    w_iota = torch.arange(Wt, device=dev)[:, None]
    flat_get = (w_iota * nbp + keys_l).reshape(-1)
    cur = tuple(b.reshape(L, Wt * nbp)[:, flat_get].reshape(L, Wt, cols)
                for b in buckets)
    merged = _t_add(curve, cur, s)
    # non-starts, and any slot out of range (the reference's mode="drop"),
    # write the scratch slot, which is never read
    keep = start & (keys_l >= 0) & (keys_l < nbp)
    flat_set = (w_iota * nbp + torch.where(keep, keys_l, nbp - 1)).reshape(-1)
    out = []
    for b, v in zip(buckets, merged):
        flat = b.reshape(L, Wt * nbp).clone()
        flat[:, flat_set] = v.reshape(L, Wt * cols)
        out.append(flat.reshape(L, Wt, nbp))
    return tuple(out)


def _bucket_reduce_t(curve, buckets, shifted: bool = False):
    """Per-window bucket-weighted sum of (L, Wt, NB + 2) buckets ->
    (L, Wt): sum_b b*S_b, or sum_b (b+1)*S_b when shifted (the signed
    scheme keeps |digit| v in slot v - 1).  Per-lane partials by the
    bucket-reduce kernel (B3), then the cross-lane combine."""
    nb = buckets[0].shape[2] - 2
    if nb & (nb - 1):
        # the reference's suffix-scan branch for other widths is not
        # ported: the signed scheme's NB is a power of two
        raise ValueError(f"{nb} buckets: the reduce takes a power of two")
    A, B = bucket_kernel.bucket_reduce_kernel(
        curve, tuple(b[:, :, :nb] for b in buckets))
    return _reduce_combine_t(curve, A, B, shifted)


def _reduce_combine_t(curve, A, B, shifted: bool = False):
    """Cross-lane combine of the reduce partials: T_w = C sum_c B_c +
    sum_c c A_c (+ sum_c A_c when shifted) on (L, Wt, C) x3 -> (L, Wt).

    One suffix-reduce launch (B4) over the lanes [A | B] gives sum_c c A_c
    (the weighted sum of the A half) and sum_c B_c (the plain sum of the B
    half).  C sum_c B_c + sum_c c A_c is a Horner step of two windows,
    wbits = log2(C): one launch of B5 on the window-major [sum_c c A_c |
    sum_c B_c] makes the log2(C) doublings and the add in the order of the
    reference's doubling chain; the shifted sum is one point add."""
    L, Wt, Cw = A[0].shape
    nbits = Cw.bit_length() - 1  # Cw is a power of two

    def prep(t):  # (L, Wt, Cw) x3 -> (Cw, 3L, Wt)
        return torch.cat(t, dim=0).permute(2, 0, 1)

    s = torch.cat([prep(A), prep(B)], dim=2).contiguous()  # (Cw, 3L, 2Wt)
    A2, B2 = bucket_kernel.suffix_reduce_kernel(curve, s)  # (3L, 2Wt) each
    # window 0: sum_c c A_c, window 1: sum_c B_c, each (L, Wt)
    sums = tuple(torch.cat([B2[c * L:(c + 1) * L, :Wt],
                            A2[c * L:(c + 1) * L, Wt:]], dim=1)
                 for c in range(3))
    out = bucket_kernel.horner_kernel(curve, sums, 2, nbits)
    if shifted:  # + sum_c A_c: slot i weighs i + 1 = (k C + c) + 1
        out = _t_add(curve, out, tuple(A2[c * L:(c + 1) * L, :Wt]
                                       for c in range(3)))
    return out


def _horner_t(curve, sums, W: int):
    """Window combine on the transposed layout by point adds: sums
    (L, W*B) window-major -> (L, B) x3.  The plain reference for B5."""
    L, WB = sums[0].shape
    B = WB // W
    total = tuple(s[:, (W - 1) * B:W * B] for s in sums)
    for j in range(1, W):
        for _ in range(WINDOW_BITS):
            total = _t_double(curve, total)
        start = (W - 1 - j) * B
        total = _t_add(curve, total, tuple(s[:, start:start + B] for s in sums))
    return total


def _horner_dispatch(curve, sums, W: int):
    """The scan path's Horner: one launch of B5."""
    return bucket_kernel.horner_kernel(
        curve, tuple(s.contiguous() for s in sums), W, WINDOW_BITS)


def _window_sums_packed(curve, packed, is_inf, keys_all, fold=None):
    """Scan-path window sums of a window tile, (L, Wt) x3: the bucket scan
    over pre-packed planes, the leftover merge, `fold` (the sharded MSM's
    sum over the ranks) and the reduce."""
    buckets, acc, acc_key = bucket_kernel.bucket_accumulate_packed(
        curve, packed, is_inf, keys_all, COLS, SIGNED_NBUCKETS, signed=True)
    buckets = _merge_leftovers_t(curve, buckets, acc, acc_key)
    if fold is not None:
        buckets = fold(buckets, lambda p, q: _t_add(curve, p, q))
    return _bucket_reduce_t(curve, buckets, shifted=True)


def _padded_size(n: int, multiple: int) -> int:
    """The pipelines' row count for n points: a power of two, at least
    and a multiple of `multiple`."""
    n_pad = max(multiple, 1 << (n - 1).bit_length() if n > 1 else multiple)
    return -(-n_pad // multiple) * multiple


def _pad_inputs(curve, xs, ys, zs, scalar_limbs, multiple: int | None = None):
    if multiple is None:
        multiple = COLS  # module attribute: tests may shrink it
    n = xs.shape[0]
    n_pad = _padded_size(n, multiple)
    if n_pad != n:
        extra = n_pad - n
        ident = curve.identity((extra,))
        xs = torch.cat([xs, ident[0]])
        ys = torch.cat([ys, ident[1]])
        zs = torch.cat([zs, ident[2]])
        pad_keys = torch.full((extra, scalar_limbs.shape[-1]), NBUCKETS,
                              dtype=scalar_limbs.dtype,
                              device=scalar_limbs.device)
        scalar_limbs = torch.cat([scalar_limbs, pad_keys])
    return xs, ys, zs, scalar_limbs


def _msm_reference(curve, xs, ys, zs, scalar_limbs):
    """Batched per-point scalar mul + recursive-doubling tree reduction:
    O(n * bits) group ops; the plain MSM.  n must be a power of two."""
    acc = curve.scalar_mul((xs, ys, zs), scalar_limbs)
    n = xs.shape[0]
    for i in range(n.bit_length() - 1):
        s = n >> 1 >> i
        acc = curve.add(acc, tuple(torch.roll(x, -s, dims=0) for x in acc))
    return tuple(a[0] for a in acc)


def _msm_fused(curve, points, scalar_limbs, fold=None):
    """The bucket pipeline (reference `pippenger.py:742-751`); `fold` as
    in `_window_sums_packed`."""
    xs, ys, zs = points
    xs, ys, zs, scalar_limbs = _pad_inputs(curve, xs, ys, zs, scalar_limbs)
    n, W = scalar_limbs.shape
    wt = _window_tile(n, W)
    keys_all = scalar_limbs.T  # (W, n)
    sums = []
    for w0 in range(0, W, wt):
        tile = keys_all[w0 : w0 + wt]
        buckets = _bucket_accumulate_fused(curve, xs, ys, zs, tile)
        if fold is not None:
            buckets = fold(buckets, curve.add)
        sums.append(_bucket_reduce_fused(curve, buckets))
        del buckets
    sums = tuple(torch.cat(parts, dim=0) for parts in zip(*sums))
    return _horner(curve, sums, W)


def _scan_sums(curve, points, keys_all, precomp=None, fold=None):
    """The scan path's window sums of rows of signed sort keys: keys_all
    (R, n), one row per window (of one MSM or of several) -> (L, R) x3.
    The planes are `precomp`, or packed here; the points are padded to a
    power of two and to COLS at the sink key; the rows go through in
    tiles of `_window_tile`, each tile's buckets through `fold`."""
    if precomp is None:
        precomp = bucket_kernel.pack_points(curve, *points)
    packed, is_inf = precomp
    n = packed.shape[0]
    n_pad = _padded_size(n, COLS)
    if n_pad != n:
        extra = n_pad - n
        packed = torch.cat([packed, packed.new_zeros((extra, packed.shape[1]))])
        is_inf = torch.cat([is_inf, is_inf.new_ones((extra,))])
        keys_all = torch.cat([keys_all, keys_all.new_full(
            (keys_all.shape[0], extra), 2 * SIGNED_NBUCKETS)], dim=1)
    R = keys_all.shape[0]
    wt = _window_tile(n_pad, R)
    sums = [_window_sums_packed(curve, packed, is_inf, keys_all[w0:w0 + wt],
                                fold)
            for w0 in range(0, R, wt)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*sums))


def _msm_scan(curve, points, scalar_limbs, precomp=None, fold=None):
    """The scan path (reference `pippenger.py:692-741`): signed sort keys
    (recoded before padding), the window sums (`_scan_sums`), Horner.  G1
    only; the affine input contract (z in {0, one})."""
    W = scalar_limbs.shape[1]
    sums = _scan_sums(curve, points, _signed_sort_keys(scalar_limbs).T,
                      precomp, fold)
    out = _horner_dispatch(curve, sums, W)  # (L, 1) x3
    return tuple(a[:, 0] for a in out)


def _use_pipeline(device) -> bool:
    """The bucket pipelines run on the card; CPU tensors take the plain
    `_msm_reference` (tests patch this to drive the pipelines)."""
    return device.type != "cpu"


def _use_scan_path(curve) -> bool:
    """The scan path serves prime-field (G1) curves; Fp2 (G2) curves take
    the fused pipeline."""
    return curve.ops.coord_ndim == 1


def msm(curve, points, scalar_limbs, precomp=None):
    """MSM on the curve's device.

    curve: DeviceCurve; points: (X, Y, Z) Montgomery limb batch (n, ...)
    each, affine (z in {0, one}) for the scan path; scalar_limbs: (n, W)
    raw base-2^12 limbs of the scalars.  precomp: optional (packed,
    is_inf) from `bucket_kernel.pack_points` of the same points (fixed
    bases pack once).  Returns a single projective point.
    """
    if _use_pipeline(points[0].device):
        if _use_scan_path(curve):
            return _msm_scan(curve, points, scalar_limbs, precomp=precomp)
        return _msm_fused(curve, points, scalar_limbs)
    return _msm_plain(curve, points, scalar_limbs)


def _msm_plain(curve, points, scalar_limbs):
    """`_msm_reference` after padding to a power of two with identities
    and zero scalars."""
    xs, ys, zs = points
    n = xs.shape[0]
    n_pad = 1 << (n - 1).bit_length() if n > 1 else 1
    if n_pad != n:
        ident = curve.identity((n_pad - n,))
        xs = torch.cat([xs, ident[0]])
        ys = torch.cat([ys, ident[1]])
        zs = torch.cat([zs, ident[2]])
        scalar_limbs = torch.cat([
            scalar_limbs,
            torch.zeros((n_pad - n, scalar_limbs.shape[-1]),
                        dtype=scalar_limbs.dtype, device=scalar_limbs.device),
        ])
    return _msm_reference(curve, xs, ys, zs, scalar_limbs)


def msm_many(curve, points, scalar_limbs, precomp=None):
    """M MSMs over one point set (reference `pippenger.py:754-811`), the
    shape of the EIP-7594 cell proofs: 128 quotient commitments over one
    Lagrange setup.

    scalar_limbs: (M, n, W) raw base-2^12 limbs; precomp as for `msm`.
    Returns (X, Y, Z), each with a leading (M,) axis.  G1 on the card:
    the (msm, window) pairs are M*W rows of one scan path, each scalar
    recoded to signed digits, the rows' window sums (B2-B4 and B1)
    reordered from batch-major (m*W + w) to window-major (w*M + m) and
    all M combined in one launch of B5.  Otherwise one `msm` per m: the
    plain MSM on CPU tensors, as the reference does off the pipeline, and
    the fused pipeline for G2 on the card."""
    xs, ys, zs = points
    M, n, W = scalar_limbs.shape
    if not (_use_pipeline(xs.device) and _use_scan_path(curve)):
        outs = [msm(curve, points, scalar_limbs[m], precomp)
                for m in range(M)]
        return tuple(torch.stack([o[c] for o in outs]) for c in range(3))
    keys = _signed_sort_keys(scalar_limbs.reshape(M * n, W))
    keys_all = keys.reshape(M, n, W).transpose(1, 2).reshape(M * W, n)
    sums = _scan_sums(curve, points, keys_all, precomp)  # (L, M*W)
    L = sums[0].shape[0]
    sums = tuple(s.reshape(L, M, W).transpose(1, 2).reshape(L, W * M)
                 for s in sums)
    out = _horner_dispatch(curve, sums, W)  # (L, M) x3
    return tuple(a.T for a in out)


def scalars_to_limbs(spec, scalars) -> np.ndarray:
    """Host ints -> (n, W) int32 window/limb decomposition (raw, base 2^12),
    vectorized through a bytes round trip."""
    W = -(-spec.r.bit_length() // WINDOW_BITS)
    # the signed-digit contract of _signed_sort_keys: top digit <= 2047
    if spec.r.bit_length() > WINDOW_BITS * W - 1:
        raise ValueError(
            f"{spec.r.bit_length()}-bit scalars fill all {W} windows")
    n = len(scalars)
    if n == 0:
        return np.zeros((0, W), np.int32)
    nb = (W * WINDOW_BITS + 7) // 8 + 1  # +1: 2-byte window reads stay in range
    r = spec.r
    raw = b"".join(
        (int(s) % r).to_bytes(nb, "little") for s in scalars
    )
    u8 = np.frombuffer(raw, np.uint8).reshape(n, nb).astype(np.int32)
    S = np.empty((n, W), np.int32)
    for j in range(W):
        bit = WINDOW_BITS * j
        byte, sh = bit // 8, bit % 8  # sh cycles 0/4: spans <= 2 bytes
        v = (u8[:, byte] >> sh) | (u8[:, byte + 1] << (8 - sh))
        S[:, j] = v & (NBUCKETS - 1)
    return S


def pack_scalars(spec, scalars) -> np.ndarray:
    """Host ints -> (n, P) uint32 little-endian words, the compact upload
    form (32 B per 254-bit scalar).  Unpack on the device with
    unpack_limbs."""
    nwords = -(-spec.r.bit_length() // 32)
    n = len(scalars)
    if n == 0:
        return np.zeros((0, nwords), np.uint32)
    r = spec.r
    raw = b"".join([(int(s) % r).to_bytes(4 * nwords, "little") for s in scalars])
    return np.frombuffer(raw, np.uint32).reshape(n, nwords).copy()


def unpack_limbs(packed: torch.Tensor, W: int) -> torch.Tensor:
    """(n, P) 32-bit words (uint32 bit patterns held in int32 or int64)
    -> (n, W) int32 base-2^12 window limbs, on the device."""
    pk = packed.to(torch.int64) & 0xFFFFFFFF
    pk = torch.cat([pk, torch.zeros_like(pk[..., :1])], dim=-1)
    cols = []
    for j in range(W):
        bit = WINDOW_BITS * j
        w, sh = bit // 32, bit % 32
        v = pk[..., w] >> sh
        if sh > 32 - WINDOW_BITS:
            v = v | (pk[..., w + 1] << (32 - sh))
        cols.append(v & (NBUCKETS - 1))
    return torch.stack(cols, dim=-1).to(torch.int32)


def msm_host_input(curve, affine_points, scalars):
    """Host AffinePoints and int scalars -> an MSM on the curve's device
    -> a host AffinePoint (reference `pippenger.py:874-881`)."""
    P = curve.encode_points(affine_points)
    S = torch.as_tensor(scalars_to_limbs(curve.spec, scalars),
                        device=curve.device)
    out = msm(curve, P, S)
    return curve.decode_points(tuple(a[None] for a in out))[0]


# ---------------------------------------------------------------------------
# Multi-card sharded MSM
# ---------------------------------------------------------------------------


def _gather_fold(mesh, axis_name, parts, add):
    """All-gather a tuple of equal-shaped tensors over the mesh axis (one
    collective) and fold the D copies in rank order with `add`."""
    k = len(parts)
    mine = torch.stack(parts)
    got = all_gather_rows(mesh, mine, axis_name).reshape(
        (-1, k) + mine.shape[1:])
    acc = tuple(got[0, c] for c in range(k))
    for d in range(1, got.shape[0]):
        acc = add(acc, tuple(got[d, c] for c in range(k)))
    return acc


def sharded_msm(curve, points, scalar_limbs, mesh, axis_name="shard"):
    """One MSM split over the ranks of a mesh axis; every rank calls it
    with the same global inputs and returns the same projective point.

    points: (X, Y, Z), each (n, ...), and scalar_limbs (n, W) raw base-2^12
    limbs, as numpy arrays or tensors; each rank moves only its block of
    rows to the curve's device, the last blocks filled up with identities
    at scalar 0.  The block takes `msm`'s route with the sum over the
    ranks between the bucket scan and the reduce: G1 on the card the scan
    route (its bucket arrays all-gathered and folded by B1 on the planes),
    G2 on the card the fused route (folded by B7), and CPU tensors the
    plain MSM, whose D partial points are all-gathered and folded."""
    D, rank = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    dev = curve.device
    n, W = scalar_limbs.shape
    s = max(1, -(-n // D))
    lo, hi = min(rank * s, n), min((rank + 1) * s, n)
    pts = tuple(torch.as_tensor(a[lo:hi], device=dev) for a in points)
    S = torch.as_tensor(scalar_limbs[lo:hi], device=dev)
    if hi - lo < s:
        ident = curve.identity((s - (hi - lo),))
        pts = tuple(torch.cat([a, e]) for a, e in zip(pts, ident))
        S = torch.cat([S, S.new_zeros((s - (hi - lo), W))])

    def fold(parts, add):
        return _gather_fold(mesh, axis_name, parts, add)

    if not _use_pipeline(dev):
        return fold(_msm_plain(curve, pts, S), curve.add)
    if _use_scan_path(curve):
        return _msm_scan(curve, pts, S, fold=fold)
    return _msm_fused(curve, pts, S, fold=fold)
