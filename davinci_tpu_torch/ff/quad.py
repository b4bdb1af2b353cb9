"""Batched Fp2 arithmetic: coordinates are (..., 2, L) int32 Montgomery
limb tensors over a base DeviceField.  Counterpart of
`davinci_tpu/ff/quad.py`; it puts the G2 curves on the device.
"""

from __future__ import annotations

import functools

import torch

from davinci_tpu_torch.ff.mod import (
    DeviceField,
    from_wide,
    get_device_field,
    to_wide,
)


class DeviceQuadExt:
    """Karatsuba Fp2 = Fp[u]/(u^2 - nr) over a DeviceField.

    Elements: (..., 2, L) tensors (component axis before limbs);
    coord_ndim = 2.  The `*_w` methods work on (..., 2, L/2) wide limbs.
    """

    coord_ndim = 2

    def __init__(self, df: DeviceField, nr: int):
        self.df = df
        self.device = df.device
        self.nr = nr
        self.nr_mont = df.encode_scalar(nr % df.spec.p)
        self.nr_is_m1 = nr % df.spec.p == df.spec.p - 1
        self.zero = torch.zeros((2, df.L), dtype=torch.int32,
                                device=self.device)
        self.one_mont = torch.stack([df.one_mont, df.zero])
        self._nr_w = to_wide(self.nr_mont)

    # -- host boundary ------------------------------------------------------

    def encode(self, xs) -> torch.Tensor:
        """List of (c0, c1) int tuples -> (n, 2, L) Montgomery limbs."""
        flat = []
        for c0, c1 in xs:
            flat += [c0, c1]
        return self.df.encode(flat).reshape(len(xs), 2, self.df.L)

    def decode(self, arr) -> list:
        n = int(arr.reshape(-1, 2, self.df.L).shape[0])
        flat = self.df.decode(arr.reshape(-1, self.df.L))
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(n)]

    # -- wide-limb ops --------------------------------------------------------

    def add_w(self, a, b):
        return self.df.add_w(a, b)

    def sub_w(self, a, b):
        return self.df.sub_w(a, b)

    def neg_w(self, a):
        return self.df.neg_w(a)

    def mul_w(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        df = self.df
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        # the three Karatsuba products as one batched base-field mul
        sums = df.add_w(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t0, t1, mid = df.mul_w(torch.stack([a0, a1, sums[0]]),
                               torch.stack([b0, b1, sums[1]]))
        c1 = df.sub_w(mid, df.add_w(t0, t1))
        if self.nr_is_m1:
            c0 = df.sub_w(t0, t1)
        else:
            c0 = df.add_w(t0, df.mul_w(self._nr_w, t1))
        return torch.stack([c0, c1], dim=-2)

    def select_w(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    # -- ops (12-bit limb boundary) -----------------------------------------

    def add(self, a, b):
        return self.df.add(a, b)

    def sub(self, a, b):
        return self.df.sub(a, b)

    def neg(self, a):
        return self.df.neg(a)

    def double(self, a):
        return self.df.add(a, a)

    def mul(self, a, b):
        return from_wide(self.mul_w(to_wide(a), to_wide(b)), self.df.L)

    def square(self, a):
        return self.mul(a, a)

    def select(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    def inv(self, a):
        """1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 - nr a1^2); inv(0) = 0."""
        df = self.df
        w = to_wide(a)
        a0, a1 = w[..., 0, :], w[..., 1, :]
        sq = df.mul_w(torch.stack([a0, a1]), torch.stack([a0, a1]))
        norm = df.sub_w(sq[0], df.mul_w(self._nr_w, sq[1]))
        ninv = to_wide(df.inv(from_wide(norm, df.L)))
        c = df.mul_w(torch.stack([a0, a1]), ninv)
        return from_wide(torch.stack([c[0], df.neg_w(c[1])], dim=-2), df.L)


@functools.cache
def get_device_quad(spec, nr: int, device="cuda") -> DeviceQuadExt:
    return DeviceQuadExt(get_device_field(spec, device), nr)
