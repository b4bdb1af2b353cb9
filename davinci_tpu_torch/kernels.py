"""The port's hand-written CUDA kernels: one record per kernel (where it
lives, which TPU kernel it replaces, a count of its launches) and the one
launch path they share.

Every kernel is a C function of a `csrc/*.cu` library (see `cuda_build`)
with the signature

    int fn(void* tensors..., const uint32_t* consts, long long ints...,
           void* stream)

that launches on the given stream and returns `cudaGetLastError()`.
`Kernel.launch` calls it on PyTorch's current stream, raises on a nonzero
code and only then adds one to `launches`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from davinci_tpu_torch import cuda_build


class Kernel:
    """One hand-written kernel and a count of its launches."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str,
                 n_ptr: int, n_int: int):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.n_ptr = n_ptr
        self.n_int = n_int
        self.launches = 0

    def _fn(self):
        fn = getattr(cuda_build.load(Path(self.source).stem), self.symbol)
        fn.argtypes = (
            [ctypes.c_void_p] * self.n_ptr
            + [ctypes.POINTER(ctypes.c_uint32)]
            + [ctypes.c_longlong] * self.n_int
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        return fn

    def launch(self, device, tensors, consts, ints):
        """Launch on `device`'s current stream: `tensors` are the CUDA
        tensors the kernel reads and writes, in the C function's order."""
        if len(tensors) != self.n_ptr or len(ints) != self.n_int:
            raise TypeError(f"{self.name}: wrong number of arguments")
        fn = self._fn()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors), consts,
                    *(ctypes.c_longlong(int(v)) for v in ints),
                    ctypes.c_void_p(stream))
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


_POINT_ADD = "davinci_tpu_torch/csrc/point_add.cu"
_BUCKET = "davinci_tpu_torch/csrc/bucket.cu"
_REF = "davinci_tpu/msm/bucket_kernel.py"

B1 = Kernel("point_add_g1", "davinci_point_add_g1", _POINT_ADD,
            "davinci_tpu/ec/pallas_add.py:141", 9, 1)
B2 = Kernel("bucket_scan_g1", "davinci_bucket_scan_g1", _BUCKET,
            f"{_REF}:46", 3, 3)
B3 = Kernel("bucket_reduce_g1", "davinci_bucket_reduce_g1", _BUCKET,
            f"{_REF}:585", 9, 3)
B4 = Kernel("suffix_reduce_g1", "davinci_suffix_reduce_g1", _BUCKET,
            f"{_REF}:365", 3, 2)
B5 = Kernel("horner_g1", "davinci_horner_g1", _BUCKET,
            f"{_REF}:476", 6, 3)
B7 = Kernel("point_add_g2", "davinci_point_add_g2", _POINT_ADD,
            "davinci_tpu/ec/pallas_add.py:260", 9, 1)
KERNELS = (B1, B2, B3, B4, B5, B7)
