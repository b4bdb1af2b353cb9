"""Poseidon hash (circomlib/iden3-compatible) -- the host oracle.

The host half of `davinci_tpu/hash/poseidon.py`: the Grain LFSR constant
generator, the reference permutation, `poseidon_hash` and
`multi_poseidon`, validated at import against the published iden3
vectors.  The batched device permutation (`DevicePoseidon`) is not part
of this package yet.
"""

from __future__ import annotations

import functools

from davinci_tpu_torch import fields as F

R_F = 8
# circomlib partial-round counts for t = 2..17
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]


class _Grain:
    """Grain LFSR stream from the Poseidon reference implementation."""

    def __init__(self, p_bits: int, t: int, r_f: int, r_p: int):
        bits = []
        for val, width in ((1, 2), (0, 4), (p_bits, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # shrinking: output the 2nd bit of pairs whose 1st bit is 1
        while True:
            b1 = self._next_raw()
            b2 = self._next_raw()
            if b1:
                return b2

    def next_field_element(self, p: int, n_bits: int, reject: bool = True) -> int:
        """Round constants use rejection sampling; the MDS x/y values are
        reduced mod p directly (that asymmetry is in the upstream generator
        and is load-bearing for matching circomlib's constants)."""
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_bit()
            if not reject:
                return v % p
            if v < p:
                return v


@functools.lru_cache(maxsize=None)
def poseidon_constants(t: int, p: int = F.BN254_R, n_bits: int | None = None):
    """(C, M): round constants (R*t) and MDS matrix (t x t) for state width t.

    n_bits: grain sample width.  Defaults to 254 (the circomlib/iden3
    convention, kept for every field >= 254 bits so existing instances are
    stable); fields smaller than 254 bits (toy recursion curves) sample at
    their own width — 254-bit rejection sampling against a small p would
    never terminate."""
    if n_bits is None:
        n_bits = min(254, p.bit_length())
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(n_bits, t, R_F, r_p)
    n_rounds = R_F + r_p
    C = [g.next_field_element(p, n_bits) for _ in range(n_rounds * t)]
    xs = [g.next_field_element(p, n_bits, reject=False) for _ in range(t)]
    ys = [g.next_field_element(p, n_bits, reject=False) for _ in range(t)]
    M = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)]
    return C, M


def _perm_host(state: list[int], t: int, p: int = F.BN254_R) -> list[int]:
    """Reference permutation (Hades: R_F/2 full, R_P partial, R_F/2 full)."""
    C, M = poseidon_constants(t, p)
    r_p = N_ROUNDS_P[t - 2]
    half = R_F // 2
    ctr = 0
    s = list(state)

    def ark():
        nonlocal ctr
        for i in range(t):
            s[i] = (s[i] + C[ctr]) % p
            ctr += 1

    def sbox_all():
        for i in range(t):
            s[i] = pow(s[i], 5, p)

    def mix():
        nonlocal s
        s = [sum(M[i][j] * s[j] for j in range(t)) % p for i in range(t)]

    for _ in range(half):
        ark()
        sbox_all()
        mix()
    for _ in range(r_p):
        ark()
        s[0] = pow(s[0], 5, p)
        mix()
    for _ in range(half):
        ark()
        sbox_all()
        mix()
    return s


def poseidon_hash(inputs: list[int], p: int = F.BN254_R) -> int:
    """iden3/circomlib Poseidon: state = [0, in...], output = state[0]."""
    t = len(inputs) + 1
    assert 1 <= len(inputs) <= 16, "poseidon arity 1..16"
    state = [0] + [x % p for x in inputs]
    return _perm_host(state, t, p)[0]


def multi_poseidon(inputs: list[int], p: int = F.BN254_R) -> int:
    """Chunked Poseidon over unbounded input counts — chunk 16, recurse
    (reference crypto/hash/poseidon/multiposeidon.go:19-40)."""
    if not inputs:
        raise ValueError("no inputs provided")
    if len(inputs) <= 16:
        return poseidon_hash(inputs, p)
    hashes = [
        poseidon_hash(inputs[i : i + 16], p) for i in range(0, len(inputs), 16)
    ]
    if len(hashes) == 1:
        return hashes[0]
    if len(hashes) <= 16:
        return poseidon_hash(hashes, p)
    return multi_poseidon(hashes, p)


# ---------------------------------------------------------------------------
# Validation against published iden3 vectors (import-time self-check)
# ---------------------------------------------------------------------------

_V1 = 18586133768512220936620570745912940619677854269274689475585506675881198879027
_V2 = 7853200120776062878684798364095072458815029376092732009249414926327459813530
assert poseidon_hash([1]) == _V1, "Poseidon t=2 does not match iden3 vector"
assert poseidon_hash([1, 2]) == _V2, "Poseidon t=3 does not match iden3 vector"
