"""The port's hand-written CUDA kernels: one record per kernel (B8: per
variant) and limb count (where it lives, which TPU kernel it replaces, a count of its
launches) and the one launch path they share.

Every kernel is a C function of a `csrc/*.cu` library (see `cuda_build`)
with the signature

    int fn(void* tensors..., const uint32_t* consts, long long ints...,
           void* stream)

that launches on the given stream and returns `cudaGetLastError()`.
`Kernel.launch` calls it on PyTorch's current stream, raises on a nonzero
code and only then adds one to `launches`.  Each library is built per
limb count L (`cuda_build.limbs_of`); a kernel has one record per L it is
built for, so the counts show which instantiation ran: `B1` is the
L = 22 build of the G1 add, `B1.at(32)` (`B1_L32`) the L = 32 one and
`B1.at(64)` (`B1_L64`) BW6-761's.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from davinci_tpu_torch import cuda_build


class Kernel:
    """One hand-written kernel at one limb count, and a count of its
    launches."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str,
                 n_ptr: int, n_int: int, limbs: int = 22):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.n_ptr = n_ptr
        self.n_int = n_int
        self.limbs = limbs
        self.launches = 0
        self.builds = {limbs: self}  # every record of this kernel, by L
        self._cfn = None  # the bound C function, once loaded

    def build_for(self, limbs: int) -> "Kernel":
        """The record of the same kernel built for L = `limbs`."""
        k = Kernel(f"{self.name}_l{limbs}", self.symbol, self.source,
                   self.replaces, self.n_ptr, self.n_int, limbs)
        k.builds = self.builds
        self.builds[limbs] = k
        return k

    def at(self, limbs: int) -> "Kernel":
        """The build for L = `limbs`; raises where there is none."""
        k = self.builds.get(limbs)
        if k is None:
            raise ValueError(
                f"{self.name}: built for L = "
                f"{' and '.join(map(str, sorted(self.builds)))} only, "
                f"not L = {limbs}")
        return k

    def _fn(self):
        """The C function, loaded (and built) at the first launch, with
        its argument types set once."""
        if self._cfn is None:
            lib = cuda_build.load(Path(self.source).stem, self.limbs)
            fn = getattr(lib, self.symbol)
            fn.argtypes = (
                [ctypes.c_void_p] * self.n_ptr
                + [ctypes.POINTER(ctypes.c_uint32)]
                + [ctypes.c_longlong] * self.n_int
                + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._cfn = fn
        return self._cfn

    def launch(self, device, tensors, consts, ints):
        """Launch on `device`'s current stream: `tensors` are the CUDA
        tensors the kernel reads and writes, in the C function's order.
        A device context is entered only when `device` is not the
        current device."""
        if len(tensors) != self.n_ptr or len(ints) != self.n_int:
            raise TypeError(f"{self.name}: wrong number of arguments")
        fn = self._cfn or self._fn()
        ptrs = [t.data_ptr() for t in tensors]
        index = device.index  # a tensor's device: always indexed
        # the argument types convert the ints; the raw stream lookup is the
        # one Triton's launcher makes
        if index == torch.cuda.current_device():
            rc = fn(*ptrs, consts, *ints,
                    torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*ptrs, consts, *ints,
                        torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch error {rc}")
        self.launches += 1


def check_tensors(kernel, tensors):
    """The device of int32 `tensors` that all lie on one device: "cpu"
    (the caller then runs the plain version) or a CUDA device; raises on
    anything else."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{kernel.name}: operands on several devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel.name}: unsupported device {device}")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{kernel.name}: operands must be int32")
    return device


def field_consts(kernel, spec, b3=(0, 0), nr=0, nr_is_m1=False,
                 b3_small=0, b3_neg=False):
    """The Consts struct of csrc/field.cuh for field `spec` as a ctypes
    uint32 array (b3 and nr: Montgomery-form ints of the curve; b3_small:
    G1's |3b| as an integer where it is small, else 0, and b3_neg where 3b
    is its negative, a word that only the L = 64 build's Consts has; the
    six-thread mixed add of csrc/group6.cuh multiplies by it with
    additions).  Raises
    where no build of `kernel` serves the field: L without a build, or a
    modulus of 32N - 1 bits or more (2p must fit N words)."""
    L = spec.num_limbs
    kernel.at(L)
    n = 12 * L // 32  # 32-bit words of an element in the kernels
    p = spec.p
    if p.bit_length() >= 32 * n:
        raise ValueError(
            f"{kernel.name}: {spec.name} has a {p.bit_length()}-bit modulus;"
            f" the L = {L} build takes moduli below 2^{32 * n - 1}")

    def w(x):
        return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(n)]

    np0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    vals = (w(p) + w(b3[0]) + w(b3[1]) + w(nr) + [np0, int(nr_is_m1)]
            + w(spec.r_mod_p) + [b3_small, int(b3_neg)])
    return (ctypes.c_uint32 * len(vals))(*vals)


_POINT_ADD = "davinci_tpu_torch/csrc/point_add.cu"
_BUCKET = "davinci_tpu_torch/csrc/bucket.cu"
_MONT_MUL = "davinci_tpu_torch/csrc/mont_mul.cu"
_ADDK = "davinci_tpu_torch/csrc/addk.cu"
_REF = "davinci_tpu/msm/bucket_kernel.py"

B1 = Kernel("point_add_g1", "davinci_point_add_g1", _POINT_ADD,
            "davinci_tpu/ec/pallas_add.py:141", 9, 2)
B2 = Kernel("bucket_scan_g1", "davinci_bucket_scan_g1", _BUCKET,
            f"{_REF}:46", 3, 3)
B3 = Kernel("bucket_reduce_g1", "davinci_bucket_reduce_g1", _BUCKET,
            f"{_REF}:585", 9, 5)
B4 = Kernel("suffix_reduce_g1", "davinci_suffix_reduce_g1", _BUCKET,
            f"{_REF}:365", 3, 3)
B5 = Kernel("horner_g1", "davinci_horner_g1", _BUCKET,
            f"{_REF}:476", 6, 3)
B6 = Kernel("mont_mul", "davinci_mont_mul", _MONT_MUL,
            "davinci_tpu/ff/pallas_mul.py:31", 3, 3)
B7 = Kernel("point_add_g2", "davinci_point_add_g2", _POINT_ADD,
            "davinci_tpu/ec/pallas_add.py:260", 9, 1)
# B5 on G2: the fused route's window combine in one launch, in place of
# the reference's jitted loop of _point_add2_kernel steps
B5G2 = Kernel("horner_g2", "davinci_horner_g2", _BUCKET,
              "davinci_tpu/msm/pippenger.py:500", 6, 3)
# the L = 32 builds (BLS12-381/377 G1, G2 and base fields)
B1_L32, B2_L32, B3_L32, B4_L32, B5_L32, B6_L32, B7_L32, B5G2_L32 = (
    k.build_for(32) for k in (B1, B2, B3, B4, B5, B6, B7, B5G2))
# the L = 64 builds (BW6-761: G1 and G2 both over Fp, both on the scan
# path); B7 and B5's G2 build serve Fp2 only, and no Fp2 curve has L = 64
B1_L64, B2_L64, B3_L64, B4_L64, B5_L64, B6_L64 = (
    k.build_for(64) for k in (B1, B2, B3, B4, B5, B6))
# B8: the point-add experiment's four G1 add designs, BN254 at L = 22 only
# (ec/addk_exp.py); the field's constants are compiled in (consts NULL)
B8 = {v: Kernel(f"addk_{v}", f"davinci_addk_{v}", _ADDK,
                "scripts/addk_exp.py:354", 9, 1)
      for v in ("v2d", "lazy", "kara", "addonly")}
KERNELS = (B1, B2, B3, B4, B5, B6, B7, B5G2,
           B1_L32, B2_L32, B3_L32, B4_L32, B5_L32, B6_L32, B7_L32, B5G2_L32,
           *B8.values(),
           B1_L64, B2_L64, B3_L64, B4_L64, B5_L64, B6_L64)
