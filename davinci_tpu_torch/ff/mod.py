"""Batched modular (Montgomery) arithmetic on limb tensors: the field
layer under the NTT, the witness fold and the affine normalisation.
Counterpart of `davinci_tpu/ff/mod.py`.

Every Montgomery product (`mul`, `mul_w`, `square`, `to_mont`,
`from_mont`, `pow_const`, `inv`, and so the Fp2 products of `ff/quad.py`)
goes through `ff/cuda_mul.mont_mul`: kernel B6 on CUDA tensors, which
raises for a field it has no build for, and on CPU tensors the plain
composition below (`mul_plain`).  Additions and subtractions are plain
PyTorch on both.

Boundary format (the reference's, so tensors compare element for element):
  * a field element is (..., L) int32 12-bit limbs, least significant
    first, in Montgomery form with radix R = 2^(12 L);
  * every operation is batched over the leading dims and returns
    canonical limbs of a value in [0, p).

Inside, the arithmetic runs on "wide" limbs: pairs of 12-bit limbs packed
into one 24-bit limb held in int64, n = ceil(L/2) of them, so a product
column (n products < 2^48) fits int64 with room to spare.  At even L
(`fields._limbs_for`) R = 2^(24 n) exactly.  At odd L (the toy curves'
fields, on CPU tensors only: no kernel is built for them) the top wide
limb holds 12 bits and R = 2^(24 n - 12), so a product first scales one
operand by 2^12 and then reduces by 2^(24 n): REDC'(2^12 a b) = a b / R.
A limb convolution is one broadcast multiply and one float64 matmul that
sums the anti-diagonals (PyTorch has no integer matmul on CUDA; float64
is exact at these sizes), or a single matmul with a Toeplitz matrix when
one operand is a constant.  Beyond 16 wide limbs (BW6-761's Fp, L = 64)
a float64 column of 24-bit products could pass 2^53, so the columns are
summed in int64 instead (`conv_cols_int`, exact there); the rest of the
arithmetic, and R = 2^(24 n), is the same.  Carries resolve without
data-dependent control flow: shift passes bound every column to one limb
plus a carry bit, then a carry-lookahead over per-element bitmasks
(generate/propagate, resolved by one integer addition, in blocks of 61
positions) finishes exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from davinci_tpu_torch.ff import cuda_mul
from davinci_tpu_torch.fields import LIMB_BITS, LIMB_MASK, FieldSpec

WIDE_BITS = 2 * LIMB_BITS
WIDE_MASK = (1 << WIDE_BITS) - 1
# lookahead bitmasks live in one int64: longer rows resolve in blocks
_LOOKAHEAD_MAX = 61


# ---------------------------------------------------------------------------
# Limb convolution and carry resolution (any limb width, int64 columns)
# ---------------------------------------------------------------------------


@functools.cache
def _diag_matrix(n: int, device) -> torch.Tensor:
    """(n*n, 2n) float64 0/1 matrix summing an outer product's
    anti-diagonals: row i*n+j has its 1 in column i+j (column 2n-1 is the
    empty carry column)."""
    s = torch.zeros((n * n, 2 * n), dtype=torch.float64)
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    s[(i * n + j).reshape(-1), (i + j).reshape(-1)] = 1.0
    return s.to(device)


def toeplitz(b: torch.Tensor) -> torch.Tensor:
    """(n,) constant limbs -> (n, 2n) float64 T with T[i, i+j] = b_j, so
    a @ T is the product columns of a and the constant b."""
    n = b.shape[-1]
    t = torch.zeros((n, 2 * n), dtype=torch.float64, device=b.device)
    for i in range(n):
        t[i, i : i + n] = b.to(torch.float64)
    return t


def conv_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product columns out[..., k] = sum_{i+j=k} a_i * b_j, k < 2n (the
    last column is 0), for int64 (..., n) limbs broadcast against each
    other.  The column sums run as a float64 matmul, which is exact here:
    every product is below 2^48 and every column below 2^53."""
    n = a.shape[-1]
    outer = a.to(torch.float64).unsqueeze(-1) * b.to(torch.float64).unsqueeze(-2)
    outer = outer.reshape(outer.shape[:-2] + (n * n,))
    return (outer @ _diag_matrix(n, a.device)).to(torch.int64)


def conv_const(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """conv_cols of a with the constant whose `toeplitz` matrix is t."""
    return (a.to(torch.float64) @ t).to(torch.int64)


# float64 columns of 24-bit products are exact up to this many wide limbs
FLOAT_MAX_LIMBS = 16


def conv_cols_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`conv_cols` summed in int64, for more than FLOAT_MAX_LIMBS wide
    limbs (BW6-761's Fp: 32), where a float64 column could pass 2^53.
    Exact while n products below 2^50 stay under 2^63.  b may be a
    constant (n,).  A small batch takes the outer product with row i
    shifted right by i (one pad, then a view with rows of 2n - 1) summed
    over the rows, a few operations; a large one one multiply-add of b,
    shifted by i, per limb i of a, which moves n times fewer bytes.  On
    one CPU thread at n = 32 the outer product is about 12 times faster
    for one element, the two cross near _INT_COLS_SMALL, and the loop is
    about 7 times faster at 4,096; with the loop alone the BW6-761
    Groth16 test files take about a quarter longer."""
    n = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if shape.numel() <= _INT_COLS_SMALL:
        outer = a.unsqueeze(-1) * b.unsqueeze(-2)
        skew = Fn.pad(outer, (0, n)).flatten(-2)[..., : n * (2 * n - 1)]
        return Fn.pad(skew.unflatten(-1, (n, 2 * n - 1)).sum(-2), (0, 1))
    out = torch.zeros(shape + (2 * n,), dtype=torch.int64, device=a.device)
    b = b.expand(shape + (n,))
    for i in range(n):
        out[..., i : i + n].add_(b * a[..., i : i + 1])
    return out


# the batch up to which `conv_cols_int` takes the outer product
_INT_COLS_SMALL = 256


def _shift_pass(x: torch.Tensor, bits: int) -> torch.Tensor:
    lo = x & ((1 << bits) - 1)
    lo[..., 1:] += x[..., :-1] >> bits  # arithmetic shift: borrow-safe
    return lo


@functools.cache
def _iota(k: int, device) -> torch.Tensor:
    return torch.arange(k, device=device, dtype=torch.int64)


def _resolve(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Columns in [0, 2^(bits+1) - 2] -> canonical limbs (carry out of the
    top position dropped).  Position i generates a carry when x_i >= 2^bits
    and propagates one when x_i == 2^bits - 1; the carries into every
    position are ((G << 1) + P) ^ P over the per-element bitmasks."""
    mask = (1 << bits) - 1
    # blocks of at most _LOOKAHEAD_MAX positions (one at L <= 32), each
    # block's carry out (bit `width` of its sum) the next one's carry in
    k = x.shape[-1]
    out, carry = [], None
    for lo in range(0, k, _LOOKAHEAD_MAX):
        block = x[..., lo:lo + _LOOKAHEAD_MAX]
        if carry is not None:
            block = block.clone()
            block[..., 0] += carry
        width = block.shape[-1]
        iota = _iota(width, x.device)
        gen = ((block >> bits) << iota).sum(-1)
        prop = ((block == mask).to(torch.int64) << iota).sum(-1)
        s = (gen << 1) + prop
        if lo + width < k:
            carry = (s >> width) & 1
        cin = s ^ prop
        out.append((block + ((cin.unsqueeze(-1) >> iota) & 1)) & mask)
    return out[0] if len(out) == 1 else torch.cat(out, -1)


def bound_limbs(x: torch.Tensor, bits: int, col_bits: int) -> torch.Tensor:
    """Shift passes over non-negative int64 columns, each below
    2^col_bits, until every column is at most 2^bits + 2^(bits-1): the
    same value mod 2^(bits * k), not yet canonical."""
    while True:
        x = _shift_pass(x, bits)
        if col_bits < 2 * bits:
            return x
        col_bits = col_bits - bits + 1


def normalize(x: torch.Tensor, bits: int, col_bits: int) -> torch.Tensor:
    """Exact carry normalisation of non-negative int64 columns, each below
    2^col_bits, to canonical `bits`-bit limbs mod 2^(bits * k)."""
    return _resolve(bound_limbs(x, bits, col_bits), bits)


def carry_fix(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """Exact carry/borrow normalisation of signed 12-bit column sums
    (|col| < 2^30) to canonical int32 limbs; carries beyond n_out are
    dropped (mod 2^(12 n_out)), as in the reference."""
    x = cols.to(torch.int64)
    if x.shape[-1] < n_out:
        x = Fn.pad(x, (0, n_out - x.shape[-1]))
    x = x[..., :n_out]
    # add K*2^12 to every column and subtract K from the next: the value
    # moves by K*2^(12 n_out) == 0 and every column becomes non-negative
    k = 1 << 19
    bias = torch.full((n_out,), k * (1 << LIMB_BITS) - k, dtype=torch.int64,
                      device=x.device)
    bias[0] = k << LIMB_BITS
    return normalize(x + bias, LIMB_BITS, 33).to(torch.int32)


def to_wide(x: torch.Tensor) -> torch.Tensor:
    """(..., L) 12-bit limbs -> (..., ceil(L/2)) int64 24-bit limbs (at
    odd L the top one holds the last 12-bit limb alone)."""
    x = x.to(torch.int64)
    if x.shape[-1] % 2:
        x = Fn.pad(x, (0, 1))
    return x[..., 0::2] | (x[..., 1::2] << LIMB_BITS)


def from_wide(w: torch.Tensor, L: int | None = None) -> torch.Tensor:
    """(..., n) int64 24-bit limbs -> (..., L) int32 12-bit limbs: L = 2n
    by default, 2n - 1 for an odd-L field (its top limb is then 0)."""
    parts = torch.stack((w & LIMB_MASK, w >> LIMB_BITS), dim=-1)
    out = parts.reshape(w.shape[:-1] + (2 * w.shape[-1],)).to(torch.int32)
    return out if L is None or L == out.shape[-1] else out[..., :L]


def _wide_const(v: int, n: int, device) -> torch.Tensor:
    return torch.tensor([(v >> (WIDE_BITS * i)) & WIDE_MASK for i in range(n)],
                        dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# DeviceField
# ---------------------------------------------------------------------------


class DeviceField:
    """Batched Montgomery field arithmetic for one FieldSpec on one device.

    Public methods take and return (..., L) int32 Montgomery limbs.  The
    `*_w` methods are the same operations on (..., ceil(L/2)) int64 wide
    limbs; compositions (point adds, NTT stages) stay wide between
    operations.  An odd L is served on the CPU only; above 16 wide limbs
    the product columns are summed in int64 (`conv_cols_int`).
    """

    coord_ndim = 1
    MAX_LIMBS = 64  # BW6-761's Fp; B6 is built for L = 22, 32 and 64
    # elements per chunk of a plain mul: the float64 outer product is
    # (L/2)^2 * 8 bytes per element (~1 KB at L=22); B6 needs no cap
    _MUL_CHUNK = 1 << 19

    def __init__(self, spec: FieldSpec, device="cuda"):
        device = torch.device(device)
        if spec.num_limbs > self.MAX_LIMBS or (spec.num_limbs % 2
                                               and device.type != "cpu"):
            raise ValueError(
                f"{spec.name}: {spec.num_limbs} limbs on {device.type} (need"
                f" a count <= {self.MAX_LIMBS}, even off the CPU)")
        self.spec = spec
        self.device = device
        self.L = spec.num_limbs
        self.n = (self.L + 1) // 2
        self._odd = self.L % 2 == 1
        self._int_cols = self.n > FLOAT_MAX_LIMBS
        self.p_limbs = self._t(spec.to_limbs_unreduced(spec.p))
        self.nprime_limbs = self._t(spec.to_limbs_unreduced(spec.n_prime))
        self.zero = torch.zeros(self.L, dtype=torch.int32, device=self.device)
        self.one_mont = self._t(spec.to_limbs(spec.r_mod_p))
        self.raw_one = self._t(spec.to_limbs(1))  # REDC(a * 1) = from_mont
        self.r2 = self._t(spec.to_limbs(spec.r2_mod_p))
        self._p_w = to_wide(self.p_limbs)
        # -p^-1 mod 2^(24 n): R's n' at even L, the odd L's REDC radix
        wide_r = 1 << (WIDE_BITS * self.n)
        self._np_w = _wide_const(-pow(spec.p, -1, wide_r) % wide_r, self.n,
                                 self.device)
        top = 1 << WIDE_BITS
        # borrow-free constants: x + bias - p over n+1 limbs (csub), and
        # a - b + p + bias over n limbs (sub); bias adds 2^24 to every limb
        # and takes 1 from the next, which only moves the dropped top
        bias = torch.full((self.n + 1,), top - 1, dtype=torch.int64,
                          device=self.device)
        bias[0] = top
        self._csub_c = bias - torch.cat([self._p_w, bias[:1] * 0])
        self._sub_c = bias[: self.n] + self._p_w
        self._prod_bits = 2 * WIDE_BITS + self.n.bit_length() + 1
        if self._int_cols:  # the constants as wide limbs
            self._conv = self._conv_c = conv_cols_int
            self._np_t, self._p_t = self._np_w, self._p_w
        else:
            self._conv, self._conv_c = conv_cols, conv_const
            self._np_t = toeplitz(self._np_w)[:, : self.n]  # low half: mod R
            self._p_t = toeplitz(self._p_w)

    def _t(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

    # -- host boundary ------------------------------------------------------

    def encode(self, xs) -> torch.Tensor:
        """list[int] (normal form) -> (n, L) Montgomery limbs on the device."""
        return self.to_mont(self._t(self.spec.batch_to_limbs(xs)))

    def encode_scalar(self, x: int) -> torch.Tensor:
        return self._t(self.spec.to_limbs(x * self.spec.r % self.spec.p))

    def decode(self, arr) -> list[int]:
        """(..., L) Montgomery limbs -> list of ints in normal form."""
        return self.spec.batch_from_limbs(self.from_mont(arr).cpu().numpy())

    def encode_raw(self, xs) -> torch.Tensor:
        """list[int] -> limbs WITHOUT Montgomery scaling."""
        return self._t(self.spec.batch_to_limbs(xs))

    def to_mont(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw residue limbs (any value < R) -> Montgomery form."""
        return self.mul(raw, self.r2)

    def from_mont(self, mont: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> raw residue limbs (REDC of the value)."""
        return self.mul(mont, self.raw_one)

    # -- wide-limb core -----------------------------------------------------

    def _chunked(self, fn, *ws):
        """fn over the flattened batch in _MUL_CHUNK slices (bounds the
        transient convolution memory of huge batches)."""
        shape = torch.broadcast_shapes(*(w.shape[:-1] for w in ws))
        batch = int(np.prod(shape)) if shape else 1
        if batch <= self._MUL_CHUNK:
            return fn(*ws)
        flat = [w.expand(shape + w.shape[-1:]).reshape(-1, w.shape[-1])
                for w in ws]
        outs = [fn(*(f[i : i + self._MUL_CHUNK] for f in flat))
                for i in range(0, batch, self._MUL_CHUNK)]
        out = torch.cat(outs)
        return out.reshape(shape + out.shape[-1:])

    def _csub_w(self, x: torch.Tensor) -> torch.Tensor:
        """Canonical x in [0, 2p) -> x mod p."""
        top = self._csub_c[self.n :].expand(x.shape[:-1] + (1,))
        d = normalize(torch.cat([x + self._csub_c[: self.n], top], -1),
                      WIDE_BITS, WIDE_BITS + 1)
        borrow = d[..., self.n] != 0
        return torch.where(borrow.unsqueeze(-1), x, d[..., : self.n])

    def _redc_w(self, t: torch.Tensor) -> torch.Tensor:
        """Montgomery reduction of t < R*p given as n or 2n wide limbs of at
        most 2^24 + 2^23 each (canonical, or `bound_limbs` output: only the
        value of t matters, and bounded limbs keep the products exact).
        m = t * n' mod R is canonical, so (t + m p)/R < 2p.  R here is
        2^(24 n), the field's R at even L."""
        n = self.n
        m = normalize(self._conv_c(t[..., :n], self._np_t)[..., :n],
                      WIDE_BITS, self._prod_bits)
        s = self._conv_c(m, self._p_t)
        s[..., : t.shape[-1]] += t
        # t + m*p == 0 mod R and (t + m*p)/R < 2p: the low half vanishes
        s = normalize(s, WIDE_BITS, self._prod_bits + 1)
        return self._csub_w(s[..., n:])

    def _mul_direct_w(self, a, b):
        if self._odd:  # a < 2^(24 n - 12): a * 2^12 stays n canonical limbs
            hi = a >> LIMB_BITS
            a = (a & LIMB_MASK) << LIMB_BITS
            a[..., 1:] |= hi[..., :-1]
        t = bound_limbs(self._conv(a, b), WIDE_BITS, self._prod_bits)
        return self._redc_w(t)

    def mul_w(self, a, b):
        if a.device.type == "cpu":
            return self._chunked(self._mul_direct_w, a, b)
        return to_wide(cuda_mul.mont_mul(self, from_wide(a, self.L),
                                         from_wide(b, self.L)))

    def add_w(self, a, b):
        # a + b < 2p < R, so n limbs suffice
        return self._csub_w(normalize(a + b, WIDE_BITS, WIDE_BITS + 1))

    def sub_w(self, a, b):
        return self._csub_w(
            normalize(a - b + self._sub_c, WIDE_BITS, WIDE_BITS + 2))

    def neg_w(self, a):
        return self._csub_w(
            normalize(self._sub_c - a, WIDE_BITS, WIDE_BITS + 2))

    def select_w(self, cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)

    # -- core ops (12-bit limb boundary) ------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product: (a*b*R^{-1}) mod p (B6 on CUDA tensors)."""
        return cuda_mul.mont_mul(self, a, b)

    def mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch Montgomery product (B6's plain version)."""
        return from_wide(self._chunked(self._mul_direct_w, to_wide(a),
                                       to_wide(b)), self.L)

    def square(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return from_wide(self.add_w(to_wide(a), to_wide(b)), self.L)

    def sub(self, a, b):
        return from_wide(self.sub_w(to_wide(a), to_wide(b)), self.L)

    def neg(self, a):
        return from_wide(self.neg_w(to_wide(a)), self.L)

    def double(self, a):
        return self.add(a, a)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def select(self, cond, a, b):
        """cond ? a : b, cond shaped (...,)."""
        return torch.where(cond.unsqueeze(-1), a, b)

    def pow_const(self, a, e: int):
        """a^e for a host-known exponent (square-and-multiply)."""
        acc = self.one_mont.expand(a.shape)
        if e == 0:
            return acc.clone()
        base = a
        for i in range(e.bit_length()):
            if (e >> i) & 1:
                acc = self.mul(acc, base)
            if i + 1 < e.bit_length():
                base = self.mul(base, base)
        return acc

    def inv(self, a):
        """Batched inversion via Fermat (a^{p-2}); inv(0) returns 0."""
        return self.pow_const(a, self.spec.p - 2)


@functools.cache
def get_device_field(spec: FieldSpec, device="cuda") -> DeviceField:
    return DeviceField(spec, torch.device(device))
