"""Batched short-Weierstrass point arithmetic (a=0 curves), generic over
the coordinate field backend (Fp limb tensors or Fp2 pairs).  Counterpart
of `davinci_tpu/ec/weier.py`.

Points are (X, Y, Z) projective tensors; identity is (0, 1, 0).  Every
group operation is the complete RCB15 addition (Algorithm 7, a=0), so
MSM accumulation needs no doubling or identity special cases.  `add` goes
through `ec.cuda_add`: on a CUDA tensor it launches the hand-written
kernel (B1 for Fp, B7 for Fp2), on a CPU tensor it runs the plain
PyTorch composition beside that kernel.
"""

from __future__ import annotations

import functools

import torch

from davinci_tpu_torch.ec import cuda_add
from davinci_tpu_torch.ff.mod import get_device_field
from davinci_tpu_torch.ff.quad import get_device_quad
from davinci_tpu_torch.fields import LIMB_BITS


class DeviceCurve:
    """Batched projective point ops for a CurveSpec on one device.

    A point batch is a tuple (X, Y, Z) of Montgomery limb tensors shaped
    (..., L) for prime fields or (..., 2, L) for Fp2.
    """

    def __init__(self, spec, device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        fld = spec.fld
        if hasattr(fld, "p"):  # prime field
            self.ops = get_device_field(spec.field_spec, self.device)
            self.df = self.ops
            self.b3 = self.ops.encode_scalar(3 * spec.b_ff.v % spec.field_spec.p)
        else:  # QuadExt over a prime field
            self.ops = get_device_quad(spec.field_spec, fld.nr, self.device)
            self.df = self.ops.df
            b0, b1 = spec.b_ff.v
            p = spec.field_spec.p
            self.b3 = torch.stack([
                self.df.encode_scalar(3 * b0 % p),
                self.df.encode_scalar(3 * b1 % p),
            ])
        self._eshape = (
            (2, self.df.L) if self.ops.coord_ndim == 2 else (self.df.L,)
        )

    # -- encoding -----------------------------------------------------------

    def identity(self, shape=()) -> tuple:
        x = torch.zeros(shape + self._eshape, dtype=torch.int32,
                        device=self.device)
        y = self.ops.one_mont.expand(shape + self._eshape).clone()
        return (x, y, x.clone())

    def _enc_coord_list(self, vals):
        if self.ops.coord_ndim == 1:
            return self.df.encode(vals)
        return self.ops.encode(vals)

    def encode_points(self, pts) -> tuple:
        """List of host AffinePoints -> (X, Y, Z) batch (Montgomery)."""
        one = 1 if self.ops.coord_ndim == 1 else (1, 0)
        zero = 0 if self.ops.coord_ndim == 1 else (0, 0)
        xs, ys, zs = [], [], []
        for pt in pts:
            if pt.infinity:
                xs.append(zero)
                ys.append(one)
                zs.append(zero)
            else:
                xs.append(pt.x.v)
                ys.append(pt.y.v)
                zs.append(one)
        return (
            self._enc_coord_list(xs),
            self._enc_coord_list(ys),
            self._enc_coord_list(zs),
        )

    def decode_points(self, p) -> list:
        """(X, Y, Z) batch -> list of host AffinePoints."""
        from davinci_tpu_torch.curves import AffinePoint
        from davinci_tpu_torch.towers import FF

        fld = self.spec.fld
        if self.ops.coord_ndim == 1:
            X, Y, Z = (self.df.decode(a) for a in p)
        else:
            X, Y, Z = (self.ops.decode(a) for a in p)
        out = []
        for x, y, z in zip(X, Y, Z):
            if z == 0 or z == (0, 0):
                out.append(AffinePoint(self.spec, None, None))
            elif self.ops.coord_ndim == 1:
                zi = pow(z, -1, fld.p)
                out.append(AffinePoint(self.spec, fld(x * zi), fld(y * zi)))
            else:
                zi = FF(fld, z).inv()
                out.append(
                    AffinePoint(self.spec, FF(fld, x) * zi, FF(fld, y) * zi)
                )
        return out

    # -- group ops (branchless, batched) ------------------------------------

    def add(self, p, q):
        """Complete projective addition, RCB15 Algorithm 7 (a=0, 12M)."""
        if self.ops.coord_ndim == 2:
            return cuda_add.point_add_fp2(self, p, q)
        return cuda_add.point_add(self, p, q)

    def double(self, p):
        return self.add(p, p)

    def neg(self, p):
        X, Y, Z = p
        return (X, self.ops.neg(Y), Z)

    def select(self, cond, p, q):
        """cond ? p : q, cond shaped like the batch dims."""
        return tuple(self.ops.select(cond, a, b) for a, b in zip(p, q))

    def batch_shape(self, p):
        return p[0].shape[: p[0].ndim - self.ops.coord_ndim]

    def scalar_mul(self, p, scalar_limbs, nbits: int | None = None):
        """Batched double-and-add: scalar_limbs is the *raw* base-2^12 limb
        tensor of the scalars, shape (..., Ls).  Each step runs the add
        and the doubling as one batched point add.  The walk stops at the
        largest scalar's top bit: the steps above it leave every sum as it
        is."""
        if nbits is None:
            nbits = self.spec.r.bit_length()
        nbits = min(nbits, _top_bit(scalar_limbs))
        acc = self.identity(self.batch_shape(p))
        base = p
        for j in range(nbits):
            bit = (scalar_limbs[..., j // LIMB_BITS] >> (j % LIMB_BITS)) & 1
            both = self.add(
                tuple(torch.stack([a, b]) for a, b in zip(acc, base)),
                tuple(torch.stack([b, b]) for b in base),
            )
            acc = self.select(bit == 1, tuple(a[0] for a in both), acc)
            base = tuple(a[1] for a in both)
        return acc

    # -- affine conversion (batched inversion) ------------------------------

    def to_affine(self, p):
        """(X,Y,Z) -> (x, y, is_inf) with x,y affine Montgomery limbs."""
        f = self.ops
        X, Y, Z = p
        zinv = f.inv(Z)  # inv(0) = 0 by construction
        x = f.mul(X, zinv)
        y = f.mul(Y, zinv)
        return x, y, f.is_zero(Z)

    def affine_encoding(self, p):
        """(X,Y,Z) batch -> the MSM affine-input encoding: x/y affine
        Montgomery limbs and z in {0, one_mont} flagging infinity."""
        x, y, inf = self.to_affine(p)
        infc = (
            inf[..., None] if self.ops.coord_ndim == 1 else inf[..., None, None]
        )
        zero = torch.zeros_like(x)
        one = self.ops.one_mont.expand(x.shape)
        return (
            torch.where(infc, zero, x),
            torch.where(infc, self.ops.one_mont, y),
            torch.where(infc, zero, one),
        )


def _top_bit(scalar_limbs) -> int:
    """The bit length of the largest scalar of a raw base-2^12 limb batch
    (..., Ls)."""
    limbs = scalar_limbs.reshape(-1, scalar_limbs.shape[-1])
    used = (limbs != 0).any(0).nonzero()
    if len(used) == 0:
        return 0
    j = int(used[-1])
    return LIMB_BITS * j + int(limbs[:, j].max()).bit_length()


@functools.cache
def get_device_curve(spec, device="cuda") -> DeviceCurve:
    return DeviceCurve(spec, torch.device(device))
