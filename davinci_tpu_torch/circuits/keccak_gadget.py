"""In-circuit Keccak-256 (boolean gadget).

Role parity: gnark std/hash/sha3 used by the reference's vote verifier for
the Ethereum signed-message hash and address derivation
(circuits/voteverifier/vote_verifier.go:94-110 verifySigForAddress).

R1CS costs: XOR(a,b) = a + b - 2ab (1 mul); AND = 1 mul; NOT free; the
rho/pi permutation is wiring (free).  ~150k constraints per keccak-f.
State: 25 lanes x 64 bits, little-endian bit lists of boolean LinCombs.
"""

from __future__ import annotations

from davinci_tpu_torch.groth16.r1cs import ConstraintSystem

RATE_BYTES = 136  # keccak-256: r = 1088 bits
ROUNDS = 24

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _xor(cs, a, b):
    # both boolean -> a + b - 2ab
    return a + b - cs.mul(a, b) * 2


def _materialize(cs, expr):
    """Pin a wide linear expression to a fresh variable (1 constraint).
    XOR outputs are linear combinations whose term counts compound across
    rounds; without this the builder goes quadratic in terms."""
    if len(expr.terms) <= 4:
        return expr
    v = cs.priv_input(expr.value)
    cs.assert_eq(expr, v)
    return v


def _xor_many(cs, bits_list):
    acc = bits_list[0]
    for b in bits_list[1:]:
        acc = _xor(cs, acc, b)
    return _materialize(cs, acc)


def _rotl(lane, k):
    k %= 64
    return lane[-k:] + lane[:-k] if k else lane


def keccak_f(cs: ConstraintSystem, state):
    """state: 5x5 list of lanes, each a list of 64 boolean LinCombs."""
    one = cs.one
    for rnd in range(ROUNDS):
        # theta
        C = [
            [_xor_many(cs, [state[x][y][z] for y in range(5)]) for z in range(64)]
            for x in range(5)
        ]
        D = [
            [
                _xor(cs, C[(x - 1) % 5][z], C[(x + 1) % 5][(z - 1) % 64])
                for z in range(64)
            ]
            for x in range(5)
        ]
        state = [
            [
                [_xor(cs, state[x][y][z], D[x][z]) for z in range(64)]
                for y in range(5)
            ]
            for x in range(5)
        ]
        # rho + pi
        B = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROT[x][y])
        # chi: a ^ ((~b) & c)
        ns = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                lane = []
                for z in range(64):
                    nb_and_c = cs.mul(
                        one - B[(x + 1) % 5][y][z], B[(x + 2) % 5][y][z]
                    )
                    lane.append(
                        _materialize(cs, _xor(cs, B[x][y][z], nb_and_c))
                    )
                ns[x][y] = lane
        state = ns
        # iota
        rc = _RC[rnd]
        state[0][0] = [
            (one - b if (rc >> z) & 1 else b)
            for z, b in enumerate(state[0][0])
        ]
    return state


def _empty_state(cs):
    zero = cs.constant(0)
    return [[[zero] * 64 for _ in range(5)] for _ in range(5)]


def keccak256_bits(cs: ConstraintSystem, msg_bits):
    """Keccak-256 over a message given as a list of boolean LinCombs in
    byte order (bit i of byte j at index 8*j + i, LSB-first within bytes —
    matching the standard byte-oriented absorption).  Message length must
    be known at circuit-build time.  Returns 256 output bits (same
    layout)."""
    nbits = len(msg_bits)
    assert nbits % 8 == 0
    # pad10*1 with domain 0x01 (keccak legacy, as used by Ethereum)
    msg = list(msg_bits)
    zero, one = cs.constant(0), cs.one
    pad_len = RATE_BYTES - (nbits // 8) % RATE_BYTES
    pad = [zero] * (pad_len * 8)
    pad[0] = one  # 0x01 first padding byte (bit 0)
    pad[-1] = one  # 0x80 last byte (bit 7)
    msg += pad

    state = _empty_state(cs)
    rate_bits = RATE_BYTES * 8
    for off in range(0, len(msg), rate_bits):
        block = msg[off : off + rate_bits]
        for i in range(rate_bits):
            lane_idx = i // 64
            x, y = lane_idx % 5, lane_idx // 5
            z = i % 64
            state[x][y][z] = _xor(cs, state[x][y][z], block[i])
        state = keccak_f(cs, state)
    out = []
    for i in range(256):
        lane_idx = i // 64
        x, y = lane_idx % 5, lane_idx // 5
        out.append(state[x][y][i % 64])
    return out


def bytes_to_bits(cs: ConstraintSystem, data: bytes):
    """Host bytes -> constant boolean LinCombs (byte order, LSB-first)."""
    out = []
    for byte in data:
        for i in range(8):
            out.append(cs.constant((byte >> i) & 1))
    return out


def bits_to_int_value(bits) -> int:
    """Host-side value of a bit list (LSB-first byte layout -> big-endian
    integer interpretation of the byte string)."""
    by = bytearray()
    for j in range(0, len(bits), 8):
        v = 0
        for i in range(8):
            v |= int(bits[j + i].value) << i
        by.append(v)
    return int.from_bytes(bytes(by), "big")
