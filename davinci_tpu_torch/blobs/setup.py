"""EIP-4844 KZG trusted setup loading + BLS12-381 point (de)compression.

kzg_trusted_setup.txt is the public output of the Ethereum KZG ceremony (the
same data file the reference embeds at config/kzg_trusted_setup.txt): 4096
G1 points in Lagrange form and 65 G2 points in monomial form, compressed in
ZCash serialization.  Following c-kzg's load_trusted_setup, the Lagrange
points are used through the bit-reversal permutation.
"""

from __future__ import annotations

import functools
import os

from davinci_tpu_torch import curves as C
from davinci_tpu_torch import fields as F
from davinci_tpu_torch.curves import AffinePoint, sqrt_ff
from davinci_tpu_torch.towers import FF

_SETUP_PATH = os.path.join(os.path.dirname(__file__), "kzg_trusted_setup.txt")

P = F.BLS12_381_P


def decompress_g1(data: bytes) -> AffinePoint:
    """48-byte ZCash-compressed BLS12-381 G1 point."""
    assert len(data) == 48
    flags = data[0]
    c_flag = (flags >> 7) & 1
    i_flag = (flags >> 6) & 1
    s_flag = (flags >> 5) & 1
    assert c_flag == 1, "expected compressed encoding"
    if i_flag:
        return C.bls381_g1.infinity()
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    assert x < P
    fld = C.fp_bls381
    xf = fld(x)
    y = sqrt_ff(xf * xf * xf + C.bls381_g1.b_ff)
    assert y is not None, "x not on curve"
    y_int = y.v
    # s_flag: y is the lexicographically larger root
    if (y_int > P - y_int) != bool(s_flag):
        y_int = P - y_int
    return C.bls381_g1.point(x, y_int)


def decompress_g2(data: bytes) -> AffinePoint:
    """96-byte ZCash-compressed BLS12-381 G2 point (x = c1*u + c0, c1 first)."""
    assert len(data) == 96
    flags = data[0]
    c_flag = (flags >> 7) & 1
    i_flag = (flags >> 6) & 1
    s_flag = (flags >> 5) & 1
    assert c_flag == 1
    if i_flag:
        return C.bls381_g2.infinity()
    x_c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x_c0 = int.from_bytes(data[48:96], "big")
    fp2 = C.fp2_bls381
    xf = FF(fp2, (x_c0, x_c1))
    rhs = xf * xf * xf + C.bls381_g2.b_ff
    y = sqrt_ff(rhs)
    assert y is not None, "x not on G2 curve"
    y0, y1 = y.v
    # lexicographic order on (c1, c0)
    ny = (-y).v
    larger = (y1, y0) > (ny[1], ny[0])
    if larger != bool(s_flag):
        y = -y
    return AffinePoint(C.bls381_g2, xf, y)


def _brp(i: int, bits: int) -> int:
    r = 0
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


@functools.cache
def load_trusted_setup():
    """Returns (g1_lagrange_brp: list[4096 AffinePoint], g2_monomial: list[65])."""
    with open(_SETUP_PATH) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n_g1 = int(lines[0])
    n_g2 = int(lines[1])
    assert n_g1 == 4096 and n_g2 == 65
    g1 = [decompress_g1(bytes.fromhex(lines[2 + i])) for i in range(n_g1)]
    g2 = [
        decompress_g2(bytes.fromhex(lines[2 + n_g1 + i])) for i in range(n_g2)
    ]
    # bit-reversal permutation on the Lagrange points (c-kzg convention)
    bits = n_g1.bit_length() - 1
    g1_brp = [g1[_brp(i, bits)] for i in range(n_g1)]
    return g1_brp, g2
