"""BLAKE-512 — the ORIGINAL BLAKE (SHA-3 finalist, final 16-round spec),
NOT blake2b.

Role parity: iden3's go-iden3-crypto vendors dchest/blake512 and uses it
for BabyJubJub EdDSA key derivation and deterministic nonces
(babyjub.PrivateKey.Scalar / SignPoseidon) — the reference's CSP keypairs
(crypto/csp/eddsa/babyjubjub_eddsa.go) are therefore a function of
Blake-512, and seed-for-seed key parity requires this exact hash.

Pure-Python host implementation: key derivation happens once per CSP
instance and nonce derivation once per signature — never in a hot loop.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

_C = (
    0x243F6A8885A308D3, 0x13198A2E03707344,
    0xA4093822299F31D0, 0x082EFA98EC4E6C89,
    0x452821E638D01377, 0xBE5466CF34E90C6C,
    0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917,
    0x9216D5D98979FB1B, 0xD1310BA698DFB5AC,
    0x2FFD72DBD01ADFB7, 0xB8E1AFED6A267E96,
    0xBA7C9045F12C7F99, 0x24A19947B3916CF7,
    0x0801F2E2858EFC16, 0x636920D871574E69,
)

_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

_GIDX = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _MASK


def _compress(h: list, block: bytes, t: int) -> list:
    m = [int.from_bytes(block[8 * i : 8 * i + 8], "big") for i in range(16)]
    v = list(h) + [
        _C[0], _C[1], _C[2], _C[3],
        (t & _MASK) ^ _C[4], (t & _MASK) ^ _C[5],
        (t >> 64) ^ _C[6], (t >> 64) ^ _C[7],
    ]
    for rnd in range(16):
        s = _SIGMA[rnd % 10]
        for i, (a, b, c, d) in enumerate(_GIDX):
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va = (va + vb + (m[s[2 * i]] ^ _C[s[2 * i + 1]])) & _MASK
            vd = _rotr(vd ^ va, 32)
            vc = (vc + vd) & _MASK
            vb = _rotr(vb ^ vc, 25)
            va = (va + vb + (m[s[2 * i + 1]] ^ _C[s[2 * i]])) & _MASK
            vd = _rotr(vd ^ va, 16)
            vc = (vc + vd) & _MASK
            vb = _rotr(vb ^ vc, 11)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake512(data: bytes) -> bytes:
    """BLAKE-512 digest (no salt)."""
    h = list(_IV)
    n = len(data)
    nbits = 8 * n
    full, rem = divmod(n, 128)
    t = 0
    for i in range(full):
        # a full block of message bits unless it is the very last block
        # and padding would not fit — full message blocks always count 1024
        t += 1024
        h = _compress(h, data[128 * i : 128 * (i + 1)], t)
    tail = data[128 * full :]
    # padding: 0x80, zeros to offset 111 mod 128, low bit 0x01 OR'd into
    # the byte right before the 16-byte big-endian bit length (0x81 when
    # the same byte carries the 0x80 marker)
    pad = bytearray(tail)
    pad.append(0x80)
    while len(pad) % 128 != 112:
        pad.append(0)
    pad[-1] |= 0x01
    pad += nbits.to_bytes(16, "big")
    blocks = [bytes(pad[i : i + 128]) for i in range(0, len(pad), 128)]
    rembits = 8 * rem
    for j, blk in enumerate(blocks):
        if j == 0 and rem:
            t += rembits
            h = _compress(h, blk, t)
        else:
            # block holds no message bits: counter is zero per spec
            h = _compress(h, blk, 0)
    return b"".join(x.to_bytes(8, "big") for x in h)
