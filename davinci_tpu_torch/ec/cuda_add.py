"""Complete point addition (RCB15 Algorithm 7, a=0): the hand-written
CUDA kernels B1 (G1) and B7 (G2) and, beside them, their plain PyTorch
version.  Counterpart of `davinci_tpu/ec/pallas_add.py`.

`point_add` / `point_add_fp2` take (X, Y, Z) tuples of Montgomery limb
rows, (..., L) or (..., 2, L), broadcast against each other;
`point_add_planes` takes G1 coordinates as limb-major planes (L, ...), the
scan path's layout and B1's own (limb j of point i at [j, i]).  On a CPU
tensor they run `rcb15_plain`; on a CUDA tensor they launch the kernel of
`csrc/point_add.cu` built for the field's limb count (L = 22 or 32) or
raise: B1 on planes or on G1 rows (one body, built for each layout), B7
on rows.  Outputs are canonical limbs either way, so kernel and plain
version agree limb for limb.  `rcb15_mixed_plain` is
the plain version of the mixed addition (Algorithm 8) that the bucket-scan
kernel B2 runs (`csrc/field.cuh`).
"""

from __future__ import annotations

import torch

from davinci_tpu_torch.ff.mod import from_wide, to_wide
from davinci_tpu_torch.kernels import B1, B7, check_tensors, field_consts


def rcb15_plain(curve, p, q):
    """The plain PyTorch RCB15 composition (wide limbs between steps;
    independent products run as one batched mul)."""
    f = curve.ops
    X1, Y1, Z1, X2, Y2, Z2 = torch.broadcast_tensors(
        *(to_wide(a) for a in (*p, *q)))
    b3 = to_wide(curve.b3)
    st = torch.stack
    t0, t1, t2 = f.mul_w(st([X1, Y1, Z1]), st([X2, Y2, Z2]))
    s = f.add_w(st([X1, Y1, X1, X2, Y2, X2]), st([Y1, Z1, Z1, Y2, Z2, Z2]))
    m = f.mul_w(s[:3], s[3:])
    # t3 = (X1+Y1)(X2+Y2) - (t0+t1), t4 = (Y1+Z1)(Y2+Z2) - (t1+t2),
    # Y3 = (X1+Z1)(X2+Z2) - (t0+t2)
    t3, t4, Y3 = f.sub_w(m, f.add_w(st([t0, t1, t0]), st([t1, t2, t2])))
    t0 = f.add_w(f.add_w(t0, t0), t0)
    t2, Y3 = f.mul_w(b3, st([t2, Y3]))
    Z3 = f.add_w(t1, t2)
    t1 = f.sub_w(t1, t2)
    X3, t2, Y3, t1, t0, Z3 = f.mul_w(st([t4, t3, Y3, t1, t0, Z3]),
                                     st([Y3, t1, t0, Z3, t3, t4]))
    X3 = f.sub_w(t2, X3)
    Y3, Z3 = f.add_w(st([t1, Z3]), st([Y3, t0]))
    return tuple(from_wide(a, curve.df.L) for a in (X3, Y3, Z3))


def rcb15_mixed_plain(curve, p, q):
    """The plain PyTorch RCB15 Algorithm 8 (a=0): projective p plus affine
    q = (X2, Y2), not the identity; G1 only.  The kernels' mixed add."""
    f = curve.ops
    X1, Y1, Z1, X2, Y2 = torch.broadcast_tensors(
        *(to_wide(a) for a in (*p, *q)))
    b3 = to_wide(curve.b3).expand_as(Z1)
    st = torch.stack
    s = f.add_w(st([X2, X1]), st([Y2, Y1]))
    t0, t1, m, yz, xz, t2 = f.mul_w(st([X1, Y1, s[0], Y2, X2, b3]),
                                    st([X2, Y2, s[1], Z1, Z1, Z1]))
    # t3 = (X2+Y2)(X1+Y1) - (t0+t1), t4 = Y2 Z1 + Y1, Y3 = X2 Z1 + X1
    t3 = f.sub_w(m, f.add_w(t0, t1))
    t4, Y3 = f.add_w(st([yz, xz]), st([Y1, X1]))
    t0 = f.add_w(f.add_w(t0, t0), t0)
    Z3 = f.add_w(t1, t2)
    t1 = f.sub_w(t1, t2)
    Y3 = f.mul_w(b3, Y3)
    X3, t2, Y3, t1, t0, Z3 = f.mul_w(st([t4, t3, Y3, t1, t0, Z3]),
                                     st([Y3, t1, t0, Z3, t3, t4]))
    X3 = f.sub_w(t2, X3)
    Y3, Z3 = f.add_w(st([t1, Z3]), st([Y3, t0]))
    return tuple(from_wide(a, curve.df.L) for a in (X3, Y3, Z3))


def point_add(curve, p, q):
    """G1 complete addition on rows: kernel B1's row build on CUDA, plain
    on CPU."""
    return _dispatch(B1, curve, p, q, 1)


def point_add_fp2(curve, p, q):
    """G2 (Fp2) complete addition: kernel B7 on CUDA, plain on CPU."""
    return _dispatch(B7, curve, p, q)


def point_add_planes(curve, p, q):
    """G1 complete addition on limb-major planes: (X, Y, Z) of (L, ...)
    tensors, all of one shape -> contiguous (L, ...) planes.  Kernel B1 on
    CUDA; on CPU the plain add on the transposed rows."""
    device = check_tensors(B1, (*p, *q))
    shape = p[0].shape
    if any(t.shape != shape for t in (*p, *q)) or shape[:1] != curve._eshape:
        raise ValueError(f"{B1.name}: planes shaped "
                         f"{[tuple(t.shape) for t in (*p, *q)]} on "
                         f"{curve.spec.name}")
    L = shape[0]
    flat = [t.reshape(L, -1) for t in (*p, *q)]
    if device.type == "cpu":
        out = rcb15_plain(curve, tuple(a.T for a in flat[:3]),
                          tuple(a.T for a in flat[3:]))
        return tuple(a.T.contiguous().reshape(shape) for a in out)
    flat = [t.contiguous() for t in flat]
    n = flat[0].shape[1]
    out = [torch.empty_like(flat[0]) for _ in range(3)]
    if n:
        B1.at(L).launch(device, (*flat, *out), _consts(curve), (n, 0))
    return tuple(o.reshape(shape) for o in out)


def _dispatch(kernel, curve, p, q, *ints):
    device = p[0].device
    if device.type == "cpu":
        return rcb15_plain(curve, p, q)
    if device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {device}")
    return _launch(kernel, curve, p, q, ints)


def _int_of(limbs: torch.Tensor) -> int:
    return sum(int(v) << (12 * i) for i, v in enumerate(limbs.tolist()))


def _consts(curve):
    """The kernels' Consts struct (csrc/field.cuh) as a ctypes array,
    cached per curve.  Raises for a curve no kernel build serves: every
    kernel is built at L = 22 and L = 32, B1-B6 at L = 64, for moduli
    below 2^(32N - 1)."""
    cached = getattr(curve, "_cuda_add_consts", None)
    if cached is not None:
        return cached
    if curve.ops.coord_ndim == 2:
        consts = field_consts(
            B7, curve.df.spec, b3=(_int_of(curve.b3[0]), _int_of(curve.b3[1])),
            nr=_int_of(curve.ops.nr_mont), nr_is_m1=curve.ops.nr_is_m1)
    else:
        b3 = _int_of(curve.b3)
        spec = curve.df.spec
        small, neg = b3_signed_small(spec.p, spec.num_limbs, b3)
        consts = field_consts(B1, spec, b3=(b3, 0), b3_small=small,
                              b3_neg=neg)
    curve._cuda_add_consts = consts
    return consts


B3_SMALL_MAX = 1 << 8


def b3_small(p, L, b3_mont):
    """3b as an integer from its Montgomery form (radix 2^(12L)) where it
    is below B3_SMALL_MAX, else 0: the kernels' field.cuh Consts word."""
    v = b3_mont * pow(1 << (12 * L), -1, p) % p
    return v if v < B3_SMALL_MAX else 0


def b3_signed_small(p, L, b3_mont):
    """(k, neg): 3b = k, or 3b = -k where neg (BW6-761 G1, b = -1: k = 3),
    for 0 < k < B3_SMALL_MAX; (0, False) where 3b is neither.  The sign is
    compiled into the L = 64 build alone (csrc/group6.cuh's `times_b3`),
    so below 64 limbs a negative 3b counts as neither."""
    k = b3_small(p, L, b3_mont)
    if k:
        return k, False
    k = b3_small(p, L, (p - b3_mont) % p) if L > 32 else 0
    return (k, True) if k else (0, False)


def _launch(kernel, curve, p, q, ints):
    """Launch `kernel` on the broadcast rows of p and q; `ints` follow the
    row count (B1: 1, its row build)."""
    device = check_tensors(kernel, (*p, *q))
    tensors = torch.broadcast_tensors(*p, *q)
    shape = tensors[0].shape
    width = curve.df.L * curve.ops.coord_ndim
    if shape[-curve.ops.coord_ndim:] != curve._eshape:
        raise ValueError(f"{kernel.name}: coordinate shape {tuple(shape)}")
    consts = _consts(curve)
    flat = [t.contiguous().reshape(-1, width) for t in tensors]
    n = flat[0].shape[0]
    out = [torch.empty_like(flat[0]) for _ in range(3)]
    if n:
        kernel.at(curve.df.L).launch(device, (*flat, *out), consts,
                                     (n, *ints))
    return tuple(o.reshape(shape) for o in out)
