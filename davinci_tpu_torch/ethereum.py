"""Ethereum primitives: keccak256, secp256k1 ECDSA (sign/verify/recover),
EIP-191 prefixed signatures, address derivation.

Role parity: reference crypto/signatures/ethereum/signature.go:20-149 +
signer.go (go-ethereum's libsecp256k1 path).  Host-side by design — the
node verifies one signature per vote intake; the in-circuit verification
(vote-verifier circuit) is a separate gadget.

Keccak is implemented from the permutation spec (round constants and
rotation offsets are *generated*, not pasted) and validated against the
universal keccak256("") / keccak256("abc") vectors at import.
"""

from __future__ import annotations

import hmac
import hashlib

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.curves import secp256k1

# ---------------------------------------------------------------------------
# Keccak-f[1600] / keccak256 (pre-NIST padding, as Ethereum uses)
# ---------------------------------------------------------------------------


def _keccak_constants():
    # round constants via the LFSR x^8 + x^6 + x^5 + x^4 + 1
    def rc_bit(t):
        if t % 255 == 0:
            return 1
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    rcs = []
    for ir in range(24):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * ir):
                rc |= 1 << ((1 << j) - 1)
        rcs.append(rc)
    # rotation offsets: walk (x,y) = (1,0) -> (y, 2x+3y)
    rot = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        rot[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rcs, rot


_RC, _ROT = _keccak_constants()
_MASK64 = (1 << 64) - 1


def _rotl(v, n):
    return ((v << n) | (v >> (64 - n))) & _MASK64


def _keccak_f(state):
    for rnd in range(24):
        # theta
        c = [
            state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        state[0][0] ^= _RC[rnd]
    return state


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088 bits
    state = [[0] * 5 for _ in range(5)]
    # pad: 0x01 ... 0x80 (original Keccak domain)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : (i + 1) * 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        _keccak_f(state)
    out = b""
    for i in range(4):  # 32 bytes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return out


assert keccak256(b"").hex() == (
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
), "keccak256 self-check failed"  # = Ethereum's empty-code-hash constant
assert keccak256(b"abc").hex() == (
    "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
), "keccak256 self-check failed"


# ---------------------------------------------------------------------------
# secp256k1 ECDSA
# ---------------------------------------------------------------------------

N = F.SECP256K1_N
P = F.SECP256K1_P
ETH_PREFIX = b"\x19Ethereum Signed Message:\n32"


def pubkey_from_priv(priv: int):
    return secp256k1.gen.mul(priv)


def address_from_pubkey(pub) -> bytes:
    raw = pub.x.v.to_bytes(32, "big") + pub.y.v.to_bytes(32, "big")
    return keccak256(raw)[12:]


def _rfc6979_k(priv: int, msg_hash: bytes) -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256)."""
    x = priv.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, msg_hash: bytes):
    """Returns (r, s, recovery_id) with low-s normalization (Ethereum)."""
    e = int.from_bytes(msg_hash, "big") % N
    while True:
        k = _rfc6979_k(priv, msg_hash)
        R = secp256k1.gen.mul(k)
        r = R.x.v % N
        if r == 0:
            msg_hash = keccak256(msg_hash)
            continue
        s = pow(k, -1, N) * (e + r * priv) % N
        if s == 0:
            msg_hash = keccak256(msg_hash)
            continue
        rec = (R.y.v & 1) | (2 if R.x.v >= N else 0)
        if s > N // 2:
            s = N - s
            rec ^= 1
        return r, s, rec


def verify(pub, msg_hash: bytes, r: int, s: int) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    e = int.from_bytes(msg_hash, "big") % N
    w = pow(s, -1, N)
    u1, u2 = e * w % N, r * w % N
    pt = secp256k1.gen.mul(u1).add(pub.mul(u2))
    if pt.infinity:
        return False
    return pt.x.v % N == r


def recover(msg_hash: bytes, r: int, s: int, rec: int):
    """Recover the public key (Ethereum ecrecover semantics)."""
    assert 0 <= rec <= 3
    x = r + (N if rec & 2 else 0)
    if x >= P:
        return None
    fld = secp256k1.fld
    xf = fld(x)
    y2 = xf * xf * xf + secp256k1.b_ff
    from davinci_tpu_torch.curves import sqrt_ff

    y = sqrt_ff(y2)
    if y is None:
        return None
    if y.v & 1 != rec & 1:
        y = -y
    from davinci_tpu_torch.curves import AffinePoint

    R = AffinePoint(secp256k1, xf, y)
    e = int.from_bytes(msg_hash, "big") % N
    rinv = pow(r, -1, N)
    # Q = r^-1 (s*R - e*G)
    return R.mul(s).add(secp256k1.gen.mul(e).neg()).mul(rinv)


def sign_eth_prefixed(priv: int, payload32: bytes):
    """EIP-191: sign keccak256(prefix || payload32) (reference
    crypto/signatures/ethereum/signature.go HashMessage)."""
    assert len(payload32) == 32
    return sign(priv, keccak256(ETH_PREFIX + payload32))


def verify_eth_prefixed(pub, payload32: bytes, r: int, s: int) -> bool:
    return verify(pub, keccak256(ETH_PREFIX + payload32), r, s)


def recover_address(payload32: bytes, r: int, s: int, rec: int) -> bytes | None:
    pub = recover(keccak256(ETH_PREFIX + payload32), r, s, rec)
    if pub is None:
        return None
    return address_from_pubkey(pub)
