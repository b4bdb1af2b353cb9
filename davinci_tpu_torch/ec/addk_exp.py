"""The point-add experiment on the card: four designs of the BN254 G1
complete add (RCB15 Algorithm 7, a = 0), the hand-written CUDA kernel B8
(`csrc/addk.cu`) and, beside it, its plain PyTorch versions.  Counterpart
of `scripts/addk_exp.py`, whose Pallas kernel `_add_2d` ran them on the TPU.

    python -m davinci_tpu_torch.ec.addk_exp [n] [variant...]

adds n = 22 x 2,048 points by default (n a multiple of 64: 64 points
tiled, the second operand rolled by 7), checks one sum against the host,
then times 30 launches chained on the output and prints, per variant,
"{name}: n={n}  {M}M adds/s  {ms} ms".  Variants (`KERNELS`, default
"v2d lazy"):

  v2d      the strict formula, field constants compiled in;
  lazy     lazy reduction, one canonicalisation at the end;
  kara     Karatsuba on the limb product;
  addonly  a diagnostic: the same 12-bit limb dataflow with every limb
           product replaced by an add (not field arithmetic).

`add_2d(curve, variant, x1, y1, z1, x2, y2, z2)` takes and returns (L, n)
int32 Montgomery limb tensors (limb j of point i at [j, i]).  On a CPU
tensor it runs the plain version, on a CUDA tensor it launches the kernel
or raises.  v2d, lazy and kara return canonical limbs, equal to B1's
(`cuda_add.point_add`) and to `cuda_add.rcb15_plain`; addonly equals
`addonly_plain` only.  Only BN254 G1 (L = 22) is built.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from davinci_tpu_torch import curves as C
from davinci_tpu_torch.ec import cuda_add
from davinci_tpu_torch.ec.weier import get_device_curve
from davinci_tpu_torch.fields import LIMB_BITS, LIMB_MASK
from davinci_tpu_torch.kernels import B8, check_tensors

KERNELS = ("v2d", "lazy", "kara", "addonly")
LIMBS = 22  # the only build: BN254's base field


def _kernel(curve, variant):
    """B8's record for `variant`; raises for a variant or curve it lacks."""
    if variant not in KERNELS:
        raise ValueError(f"unknown variant {variant!r}; one of {KERNELS}")
    kernel = B8[variant]
    if curve.spec.name != C.bn254_g1.name or curve.df.L != LIMBS:
        raise ValueError(
            f"{kernel.name}: built for BN254 G1 (L = {LIMBS}) only, not "
            f"{curve.spec.name} (L = {curve.df.L})")
    return kernel


def add_2d(curve, variant, x1, y1, z1, x2, y2, z2):
    """(X1, Y1, Z1) + (X2, Y2, Z2) on (L, n) int32 limb tensors: kernel B8
    `variant` on CUDA, its plain version on the CPU."""
    kernel = _kernel(curve, variant)
    args = (x1, y1, z1, x2, y2, z2)
    device = check_tensors(kernel, args)
    shape = x1.shape
    if len(shape) != 2 or shape[0] != LIMBS or any(a.shape != shape
                                                  for a in args):
        raise ValueError(f"{kernel.name}: operands must all be ({LIMBS}, n),"
                         f" not {[tuple(a.shape) for a in args]}")
    if device.type == "cpu":
        return add_2d_plain(curve, variant, *args)
    args = tuple(a.contiguous() for a in args)
    out = tuple(torch.empty_like(args[0]) for _ in range(3))
    if shape[1]:
        kernel.launch(device, (*args, *out), None, (shape[1],))
    return out


def add_2d_plain(curve, variant, x1, y1, z1, x2, y2, z2):
    """The plain version of B8 `variant`: v2d, lazy and kara compute the
    canonical complete add (`rcb15_plain` on the rows); addonly its
    diagnostic dataflow."""
    if variant == "addonly":
        return addonly_plain(curve, x1, y1, z1, x2, y2, z2)
    out = cuda_add.rcb15_plain(curve, (x1.T, y1.T, z1.T), (x2.T, y2.T, z2.T))
    return tuple(a.T.contiguous() for a in out)


# -- the addonly diagnostic --------------------------------------------------------
#
# scripts/addk_exp.py::_make_addonly_ops: the strict ops of 12-bit limbs with
# each limb product u[i] * v[k - i] of a column replaced by u[i] + v[k - i],
# where a constant right operand (n', p) contributes 1 and the constant b3,
# always the left operand, its limbs.  Here an element is an (L, n) int64
# tensor of limb rows; a column sum over a range of i is a difference of
# prefix sums, and every value wraps to int32 where the experiment's
# arithmetic shift and mask read it (the ripple), so the result is its
# int32 result exactly (on 12-bit limbs no column comes near 2^31).


def _i32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _ripple(cols):
    """Carry-propagate limb rows as the experiment's int32 _ripple does
    (arithmetic shift): the 12-bit limbs and the last carry.  Where no
    column reaches 2^30 nothing can wrap, and parallel carry passes give
    the same unique limbs; otherwise limb by limb, wrapping."""
    if bool((cols.abs() < 1 << 30).all()):
        x = cols.clone()
        top = torch.zeros_like(x[0])
        while True:
            c = x >> LIMB_BITS
            if not bool(c.any()):
                return x, top
            x &= LIMB_MASK
            x[1:] += c[:-1]
            top += c[-1]
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = _i32(cols[k] + carry)
        out[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out, carry


def _prefix(u):
    return torch.cat([torch.zeros_like(u[:1]), torch.cumsum(u, 0)])


def _fake_conv(u, v, out_len):
    """Columns k < out_len of sum_i (u[i] + v[k - i]), v None for a
    constant operand (each term adds 1)."""
    lu = u.shape[0]
    lv = lu if v is None else v.shape[0]
    k = torch.arange(out_len, device=u.device)
    lo = (k - lv + 1).clamp(min=0)
    hi = (k + 1).clamp(max=lu)
    hi = torch.maximum(hi, lo)  # an empty range sums to 0
    U = _prefix(u)
    cols = U[hi] - U[lo]
    if v is None:
        return cols + (hi - lo)[:, None]
    V = _prefix(v)
    return cols + V[k - lo + 1] - V[k - hi + 1]


def _addonly_ops(p_limbs):
    L = p_limbs.shape[0]
    p = p_limbs[:, None]

    def csub(s):
        d, borrow = _ripple(s - p)
        return torch.where(borrow != 0, s, d)

    def mul(a, b):
        t, _ = _ripple(_fake_conv(a, b, 2 * L))
        m, _ = _ripple(_fake_conv(t[:L], None, L))
        s, _ = _ripple(t + _fake_conv(m, None, 2 * L))
        return csub(s[L:])

    def add(a, b):
        return csub(_ripple(a + b)[0])

    def sub(a, b):
        return csub(_ripple(a - b + p)[0])

    return mul, add, sub


def _rcb15(mul, add, sub, b3, X1, Y1, Z1, X2, Y2, Z2):
    """RCB15 Algorithm 7 in the experiment's `_rcb15` order."""
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = mul(add(X1, Y1), add(X2, Y2))
    t3 = sub(t3, add(t0, t1))
    t4 = mul(add(Y1, Z1), add(Y2, Z2))
    t4 = sub(t4, add(t1, t2))
    X3 = mul(add(X1, Z1), add(X2, Z2))
    Y3 = sub(X3, add(t0, t2))
    X3 = add(t0, t0)
    t0 = add(X3, t0)
    t2 = mul(b3, t2)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    Y3 = mul(b3, Y3)
    X3 = mul(t4, Y3)
    t2m = mul(t3, t1)
    X3 = sub(t2m, X3)
    Y3 = mul(Y3, t0)
    t1 = mul(t1, Z3)
    Y3 = add(t1, Y3)
    t0 = mul(t0, t3)
    Z3 = mul(Z3, t4)
    Z3 = add(Z3, t0)
    return X3, Y3, Z3


def addonly_plain(curve, x1, y1, z1, x2, y2, z2):
    """The addonly diagnostic on (L, n) int32 limbs, as the experiment's
    `_kernel_addonly` computes it (defined on 12-bit limbs only)."""
    mul, add, sub = _addonly_ops(curve.df.p_limbs.to(torch.int64))
    args = [a.to(torch.int64) for a in (x1, y1, z1, x2, y2, z2)]
    b3 = curve.b3.to(torch.int64)[:, None].expand(args[0].shape)
    return tuple(a.to(torch.int32)
                 for a in _rcb15(mul, add, sub, b3, *args))


# -- inputs -----------------------------------------------------------------------


def experiment_points(dc, n, seed=0):
    """The experiment's inputs: 64 host points from default_rng(seed),
    tiled to n rows, and the same tiles rolled by 7 rows (so row i adds
    pts[i % 64] and pts[(i - 7) % 64]); (pts, a, b) with a, b (n, L)."""
    if n <= 0 or n % 64:
        raise ValueError(f"n = {n}: a positive multiple of 64")
    spec = dc.spec
    rng = np.random.default_rng(seed)
    pts = [spec.gen.mul(int(k)) for k in rng.integers(1, 2**31, size=64)]
    P = dc.encode_points(pts)
    a = tuple(x.repeat(n // 64, 1) for x in P)
    b = tuple(torch.roll(x, 7, 0) for x in a)
    return pts, a, b


def hard_cases(dc, pts):
    """(A, B), rows (m, L): the edge cases O + P, P + O, P + P, P + (-P),
    O + O of the points `pts`, then the same points rescaled projectively
    by lambda so that Z, X or Y is p - 1 in Montgomery form (lambda =
    -R^-1, -R^-1 / x, -R^-1 / y): sums of two such points, doublings of
    two representations of one point, and P + (-P).  They push the lazy
    variant's bounds to their largest inputs."""
    spec = dc.spec
    p = spec.field_spec.p
    Rinv = pow(1 << (LIMB_BITS * dc.df.L), -1, p)

    def rescaled(scale):
        lams = [-Rinv * scale(pt) % p for pt in pts]
        return tuple(dc.df.encode([lam * c % p for lam, c in zip(lams, coord)])
                     for coord in ([pt.x.v for pt in pts],
                                   [pt.y.v for pt in pts], [1] * len(pts)))

    base = dc.encode_points(pts)
    ident = dc.identity((len(pts),))
    near_z = rescaled(lambda pt: 1)
    near_x = rescaled(lambda pt: pow(pt.x.v, -1, p))
    near_y = rescaled(lambda pt: pow(pt.y.v, -1, p))
    roll = lambda pt: tuple(torch.roll(c, 7, 0) for c in pt)
    lhs = (ident, base, base, base, ident, near_z, near_x, near_y, near_z,
           near_x)
    rhs = (base, ident, base, dc.neg(base), ident, roll(near_x),
           roll(near_y), roll(near_z), near_x, dc.neg(near_y))
    cat = lambda pts_: tuple(torch.cat([pt[c] for pt in pts_]) for c in range(3))
    return cat(lhs), cat(rhs)


# -- the experiment's entry point ---------------------------------------------------


def _elapsed_ms(fn, device):
    """Milliseconds of fn(): CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run_variant(name, dc, a, b, pts, n, iters=30):
    """One add of the (n, L) rows a + b through B8 `name` (checked against
    the host for row 0, except addonly), then `iters` launches chained on
    the output; prints the experiment's line and returns the ms per
    launch."""
    at = tuple(x.T.contiguous() for x in a)
    bt = tuple(x.T.contiguous() for x in b)
    out = add_2d(dc, name, *at, *bt)
    if name != "addonly":
        got = dc.decode_points(tuple(x[:, :1].T for x in out))[0]
        want = pts[0].add(pts[64 - 7])
        assert got == want, (name, got, want)

    def chain():
        o = out
        for _ in range(iters):
            o = add_2d(dc, name, *o, *bt)

    ms = _elapsed_ms(chain, at[0].device) / iters
    print(f"{name}: n={n}  {n / ms / 1e3:.3f}M adds/s  {ms:.3f} ms",
          flush=True)
    return ms


def main(argv=None, device="cuda") -> int:
    """`python -m davinci_tpu_torch.ec.addk_exp [n] [variant...]`; returns
    the exit code (1 if a variant failed)."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 22 * 2048
    variants = argv[1:] or ["v2d", "lazy"]
    dc = get_device_curve(C.bn254_g1, device)
    pts, a, b = experiment_points(dc, n)
    failed = False
    for v in variants:
        try:
            run_variant(v, dc, a, b, pts, n)
        except Exception as e:
            print(f"{v}: FAILED {type(e).__name__}: {e}", flush=True)
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
