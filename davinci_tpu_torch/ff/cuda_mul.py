"""Batched Montgomery product REDC(a * b): the hand-written CUDA kernel B6
(`csrc/mont_mul.cu`) and, beside it, its plain PyTorch version.
Counterpart of `davinci_tpu/ff/pallas_mul.py`.

`mont_mul(df, a, b)` takes (..., L) int32 Montgomery limbs of the field of
`df` (a DeviceField), broadcast against each other.  On CPU tensors it
runs `mont_mul_plain`; on CUDA tensors it launches the build of B6 for the
field's limb count (L = 22 or 32) or raises, for a field that no build
serves as for a launch error.  Either way the outputs are canonical, so
kernel and plain version agree limb for limb.  As in the reference's
`DeviceField.mul`, one operand may be a raw value below R (`to_mont`'s
input); the other must be below p.
"""

from __future__ import annotations

import torch

from davinci_tpu_torch.kernels import B6, check_tensors, field_consts


def mont_mul_plain(df, a, b):
    """The plain PyTorch Montgomery product: the wide-limb float64
    convolution and reduction of `DeviceField`, in memory-capped chunks."""
    return df.mul_plain(a, b)


def consts_for(df):
    """B6's Consts array for the field of `df`, cached on it; raises for a
    field no build serves (L other than 22 and 32, such as BW6-761's 64,
    or a modulus too wide for its words, such as secp256k1's 256 bits at
    L = 22)."""
    consts = getattr(df, "_b6_consts", None)
    if consts is None:
        consts = df._b6_consts = field_consts(B6, df.spec)
    return consts


def _rows(x, shape, L):
    """x as contiguous (rows, L) whose rows repeat along `shape`'s leading
    axes (element i reads row i % rows), expanding only where needed."""
    batch = x.shape[:-1]
    while batch and batch[0] == 1:
        batch = batch[1:]
    if tuple(shape[len(shape) - len(batch):]) != tuple(batch):
        batch = tuple(shape)
        x = x.expand(tuple(shape) + (L,))
    return x.reshape(tuple(batch) + (L,)).contiguous().reshape(-1, L)


def _row_count(x, L):
    """The row count of `x` as a contiguous (rows, L) or (L,) operand, else
    None."""
    if x.dim() not in (1, 2) or x.shape[-1] != L or not x.is_contiguous():
        return None
    return x.shape[0] if x.dim() == 2 else 1


def direct_rows(a, b, L):
    """(na, nb, n, out shape) where `a` and `b` go to B6 as they are: both
    contiguous rows, (n, L), (1, L) or (L,), with equal row counts or
    one of them 1 (element i reads row i % na of a and i % nb of b; an
    empty operand makes n 0, as broadcasting does); None where they must
    be broadcast into rows first."""
    na, nb = _row_count(a, L), _row_count(b, L)
    if na is None or nb is None or not (na == nb or na == 1 or nb == 1):
        return None
    n = max(na, nb) if na and nb else 0
    return na, nb, n, (n, L) if a.dim() == 2 or b.dim() == 2 else (L,)


def mont_mul(df, a, b):
    """REDC(a * b): kernel B6 on CUDA tensors, plain on CPU tensors.

    Operands that are already contiguous rows (`direct_rows`) go to the
    kernel as they are; others are broadcast into rows first."""
    L = df.L
    if a.is_cuda and a.dtype == b.dtype == torch.int32 \
            and b.get_device() == a.get_device():
        plan = direct_rows(a, b, L)
        if plan is not None:
            na, nb, n, shape = plan
            out = torch.empty(shape, dtype=torch.int32, device=a.device)
            if n:
                B6.at(L).launch(a.device, (a, b, out), consts_for(df),
                                (na, nb, n))
            return out
    device = check_tensors(B6, (a, b))
    if device.type == "cpu":
        return mont_mul_plain(df, a, b)
    consts = consts_for(df)
    if a.shape[-1] != L or b.shape[-1] != L:
        raise ValueError(f"{B6.name}: limb axes {a.shape[-1]}, {b.shape[-1]}"
                         f" for L={L}")
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    ra, rb = _rows(a, shape, L), _rows(b, shape, L)
    out = torch.empty(tuple(shape) + (L,), dtype=torch.int32, device=device)
    n = out.numel() // L
    if n:
        B6.at(L).launch(device, (ra, rb, out), consts,
                        (ra.shape[0], rb.shape[0], n))
    return out
