"""Complete point addition (RCB15 Algorithm 7, a=0): the hand-written
CUDA kernels B1 (G1) and B7 (G2) and, beside them, their plain PyTorch
version.  Counterpart of `davinci_tpu/ec/pallas_add.py`.

`point_add` / `point_add_fp2` take (X, Y, Z) tuples of Montgomery limb
tensors, (..., L) or (..., 2, L), broadcast against each other.  On a CPU
tensor they run `rcb15_plain`; on a CUDA tensor they launch the kernel of
`csrc/point_add.cu` or raise.  Outputs are canonical limbs either way, so
kernel and plain version agree limb for limb.
"""

from __future__ import annotations

import ctypes

import torch

from davinci_tpu_torch import cuda_build
from davinci_tpu_torch.ff.mod import from_wide, to_wide

_SOURCE = "point_add"
_KERNEL_L = 22  # limbs per base-field element the kernel is built for


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and a
    count of its launches."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0


B1 = Kernel("point_add_g1", "davinci_point_add_g1",
            "davinci_tpu_torch/csrc/point_add.cu",
            "davinci_tpu/ec/pallas_add.py:141")
B7 = Kernel("point_add_g2", "davinci_point_add_g2",
            "davinci_tpu_torch/csrc/point_add.cu",
            "davinci_tpu/ec/pallas_add.py:260")
KERNELS = (B1, B7)


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
    return tuple(from_wide(a) for a in (X3, Y3, Z3))


def point_add(curve, p, q):
    """G1 complete addition: kernel B1 on CUDA, plain on CPU."""
    return _dispatch(B1, curve, p, q)


def point_add_fp2(curve, p, q):
    """G2 (Fp2) complete addition: kernel B7 on CUDA, plain on CPU."""
    return _dispatch(B7, curve, p, q)


def _dispatch(kernel, curve, p, q):
    device = p[0].device
    if device.type == "cpu":
        return rcb15_plain(curve, p, q)
    if device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {device}")
    return _launch(kernel, curve, p, q)


def _int_of(limbs: torch.Tensor) -> int:
    return sum(int(v) << (12 * i) for i, v in enumerate(limbs.tolist()))


def _words(x: int, n: int = 8) -> list[int]:
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(n)]


def _consts(curve):
    """The kernel's Consts struct as a ctypes array (cached per curve)."""
    cached = getattr(curve, "_cuda_add_consts", None)
    if cached is not None:
        return cached
    df = curve.df
    p = df.spec.p
    if df.L != _KERNEL_L or p.bit_length() > 254:
        raise ValueError(
            f"{df.spec.name}: the point-add kernel is built for L={_KERNEL_L}"
            " and moduli below 2^254"
        )
    if curve.ops.coord_ndim == 2:
        b3 = [_int_of(curve.b3[0]), _int_of(curve.b3[1])]
        nr = _int_of(curve.ops.nr_mont)
        nr_is_m1 = int(curve.ops.nr_is_m1)
    else:
        b3 = [_int_of(curve.b3), 0]
        nr, nr_is_m1 = 0, 0
    np0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    words = (_words(p) + _words(b3[0]) + _words(b3[1]) + _words(nr)
             + [np0, nr_is_m1])
    consts = (ctypes.c_uint32 * len(words))(*words)
    curve._cuda_add_consts = consts
    return consts


def _launch(kernel, curve, p, q):
    device = p[0].device
    if any(t.device != device for t in (*p, *q)):
        raise ValueError(f"{kernel.name}: operands on several devices")
    tensors = torch.broadcast_tensors(*p, *q)
    shape = tensors[0].shape
    width = curve.df.L * curve.ops.coord_ndim
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{kernel.name}: coordinates must be int32 limbs")
    if shape[-curve.ops.coord_ndim:] != curve._eshape:
        raise ValueError(f"{kernel.name}: coordinate shape {tuple(shape)}")
    consts = _consts(curve)
    flat = [t.contiguous().reshape(-1, width) for t in tensors]
    n = flat[0].shape[0]
    out = [torch.empty_like(flat[0]) for _ in range(3)]
    if n:
        fn = _symbol(kernel)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*flat, *out)),
                    consts, ctypes.c_longlong(n), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{kernel.name}: CUDA launch error {rc}")
        kernel.launches += 1
    return tuple(o.reshape(shape) for o in out)


def _symbol(kernel):
    lib = cuda_build.load(_SOURCE)
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
