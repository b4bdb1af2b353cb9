"""Multi-scalar multiplication (Pippenger) as a batched bucket pipeline.
Counterpart of `davinci_tpu/msm/pippenger.py`, for the path this package
runs: the scan composition the reference takes with the bucket-scan
kernels switched off (`pippenger.py:742-751`), which is also its G2 path.

  * Window size == LIMB_BITS (12): the j-th raw scalar limb is the bucket
    index for window j.
  * All windows at once: point adds carry a leading (W, ...) axis.
  * Bucket accumulation: points sorted by bucket (stable sort, so the
    streams match the reference's), laid out column-major (rows, COLS);
    a Python loop walks the rows, each column keeps a running segment
    accumulator and writes finished segments into the bucket array.
    Runs that cross columns are merged by a log-depth segmented
    suffix sum.
  * Bucket reduction sum_b b*S_b by a Hillis-Steele suffix scan plus a
    tree sum; windows combined by Horner (12 doublings per window).

Every group operation is `DeviceCurve.add`: on CUDA the hand-written
point-add kernels.  On a CPU tensor `msm` takes the plain double-and-add
`_msm_reference`, as the reference does on its CPU backend; `_msm_fused`
is the pipeline itself and the tests drive it directly.
"""

from __future__ import annotations

import numpy as np
import torch

from davinci_tpu_torch.fields import LIMB_BITS

WINDOW_BITS = LIMB_BITS
NBUCKETS = 1 << WINDOW_BITS  # bucket 0 contributes nothing (b * S_0, b=0)
COLS = 2048  # scan width per window: batched point adds per row
# cap on the sorted-point working set (elements of W_tile * n)
MAX_TILE_ELEMS = 1 << 23


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
    sums: tuple of (W, ...) tensors."""
    total = tuple(s[W - 1] for s in sums)
    for j in range(1, W):
        for _ in range(WINDOW_BITS):
            total = curve.double(total)
        total = curve.add(total, tuple(s[W - 1 - j] for s in sums))
    return total


def _pad_inputs(curve, xs, ys, zs, scalar_limbs, multiple: int | None = None):
    if multiple is None:
        multiple = COLS  # module attribute: tests may shrink it
    n = xs.shape[0]
    n_pad = max(multiple, 1 << (n - 1).bit_length() if n > 1 else multiple)
    n_pad = -(-n_pad // multiple) * multiple
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


def _msm_fused(curve, points, scalar_limbs):
    """The bucket pipeline (reference `pippenger.py:742-751`)."""
    xs, ys, zs = points
    xs, ys, zs, scalar_limbs = _pad_inputs(curve, xs, ys, zs, scalar_limbs)
    n, W = scalar_limbs.shape
    wt = _window_tile(n, W)
    keys_all = scalar_limbs.T  # (W, n)
    sums = []
    for w0 in range(0, W, wt):
        tile = keys_all[w0 : w0 + wt]
        buckets = _bucket_accumulate_fused(curve, xs, ys, zs, tile)
        sums.append(_bucket_reduce_fused(curve, buckets))
        del buckets
    sums = tuple(torch.cat(parts, dim=0) for parts in zip(*sums))
    return _horner(curve, sums, W)


def msm(curve, points, scalar_limbs):
    """MSM on the curve's device.

    curve: DeviceCurve; points: (X, Y, Z) Montgomery limb batch (n, ...)
    each; scalar_limbs: (n, W) raw base-2^12 limbs of the scalars.
    Returns a single projective point.  CUDA tensors run the bucket
    pipeline; CPU tensors run the plain `_msm_reference`.
    """
    xs, ys, zs = points
    if xs.device.type != "cpu":
        return _msm_fused(curve, points, scalar_limbs)
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


def scalars_to_limbs(spec, scalars) -> np.ndarray:
    """Host ints -> (n, W) int32 window/limb decomposition (raw, base 2^12),
    vectorized through a bytes round trip."""
    W = -(-spec.r.bit_length() // WINDOW_BITS)
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
