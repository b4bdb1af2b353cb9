"""Array-native MSM point bases for proving keys.  Counterpart of
`davinci_tpu/groth16/bases.py`.

EncodedBases stores the device encoding itself -- (X, Y, Z) int32
Montgomery limb arrays in the MSM affine-input contract (z in {0, one}) --
as numpy on the host.  A set of at most one segment
(`Groth16.MSM_SEGMENT`, `MSM_SEGMENT_G2`) is uploaded to a device once
and cached there, with the scan-path MSM's plane pack of the G1 bases
beside it; a larger set is streamed from the host a segment at a time
and never cached (`Groth16._msm_enc_segmented`).
"""

from __future__ import annotations

import numpy as np
import torch

from davinci_tpu_torch.msm.bucket_kernel import pack_points


class EncodedBases:
    """(X, Y, Z) numpy int32 arrays shaped (n, L) (G1) or (n, 2, L) (G2),
    Montgomery limbs, z in {0, one_mont} per the MSM affine contract."""

    __slots__ = ("x", "y", "z", "_dev", "_packed")

    def __init__(self, x, y, z):
        self.x = np.asarray(x, np.int32)
        self.y = np.asarray(y, np.int32)
        self.z = np.asarray(z, np.int32)
        if not self.x.shape == self.y.shape == self.z.shape:
            raise ValueError("coordinate arrays differ in shape")
        self._dev = {}
        self._packed = {}

    def __len__(self) -> int:
        return self.x.shape[0]

    def device(self, device) -> tuple:
        """The (X, Y, Z) tuple as tensors on `device` (uploaded once)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.as_tensor(a, device=device) for a in (self.x, self.y, self.z)
            )
        return self._dev[device]

    def device_packed(self, device, curve) -> tuple:
        """(packed planes, is_inf) of the bases on `device` for the scan
        path's fixed-base MSM (`bucket_kernel.pack_points`), computed once
        per key and device at the set's natural length (G1 only)."""
        device = torch.device(device)
        if device not in self._packed:
            self._packed[device] = pack_points(curve, *self.device(device))
        return self._packed[device]

    def drop_device(self):
        """Forget the uploads and plane packs on every device: the next
        `device(...)` uploads again."""
        self._dev = {}
        self._packed = {}

    def __eq__(self, other):
        if not isinstance(other, EncodedBases):
            return NotImplemented
        return (
            np.array_equal(self.x, other.x)
            and np.array_equal(self.y, other.y)
            and np.array_equal(self.z, other.z)
        )

    @classmethod
    def empty(cls, dc) -> "EncodedBases":
        shape = (0, 2, dc.df.L) if dc.ops.coord_ndim == 2 else (0, dc.df.L)
        z = np.zeros(shape, np.int32)
        return cls(z, z, z)

    @classmethod
    def from_host_points(cls, dc, pts) -> "EncodedBases":
        """Host AffinePoints -> encoded bases (slow path: tests/small keys)."""
        if not pts:
            return cls.empty(dc)
        return cls.from_device(dc.encode_points(pts))

    @classmethod
    def from_device(cls, arrs) -> "EncodedBases":
        return cls(*(a.cpu().numpy() for a in arrs))

    def to_host_points(self, dc) -> list:
        """Decode back to host AffinePoints (O(n) bignum work)."""
        return dc.decode_points(self.device(dc.device))
