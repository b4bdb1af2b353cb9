"""Poseidon hash (circomlib/iden3-compatible): the host oracle and the
batched device permutation.  Counterpart of `davinci_tpu/hash/poseidon.py`.

The host half is the reference's text: the Grain LFSR constant
generator, the reference permutation, `poseidon_hash` and
`multi_poseidon`, validated at import against the published iden3
vectors.  The device half, `DevicePoseidon`, runs the permutation on a
batch of states as (..., t, L) Montgomery limb tensors: a Python loop
over the rounds, every field product on `DeviceField.mul` (kernel B6 on
CUDA tensors), the MDS mix one batched product (t, t, L) x (..., 1, t, L)
followed by an integer column sum and a bounded conditional-subtract
reduction (`_sum_mod`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.ff import get_device_field
from davinci_tpu_torch.ff.mod import carry_fix

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


# ---------------------------------------------------------------------------
# Device batched Poseidon
# ---------------------------------------------------------------------------


class DevicePoseidon:
    """Batched Poseidon permutation for a fixed arity t over BN254 Fr (or
    another field spec) on one device.

    hash(x): x is (batch, t-1, L) Montgomery limbs -> (batch, L).
    """

    def __init__(self, t: int, spec=F.bn254_fr, device="cuda"):
        self.t = t
        self.spec = spec
        self.device = torch.device(device)
        self.df = get_device_field(spec, self.device)
        L = self.df.L
        C, M = poseidon_constants(t, spec.p)
        r_p = N_ROUNDS_P[t - 2]
        self.n_rounds = R_F + r_p
        mont = lambda v: v * spec.r % spec.p
        self.C = self._t(spec.batch_to_limbs([mont(c) for c in C])).reshape(
            self.n_rounds, t, L)
        self.M = self._t(spec.batch_to_limbs(
            [mont(M[i][j]) for i in range(t) for j in range(t)])).reshape(t, t, L)
        # full-round flags
        half = R_F // 2
        self.full_flags = [1] * half + [0] * r_p + [1] * half
        # p << j multiples (L+1 limbs) for the bounded sum reduction
        ext = np.zeros((6, L + 1), np.int32)
        for j in range(6):
            v = spec.p << j
            for i in range(L + 1):
                ext[j, i] = v & 0xFFF
                v >>= 12
        self._p_mults = self._t(ext)

    def _t(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

    def _sum_mod(self, terms: torch.Tensor) -> torch.Tensor:
        """Sum over axis -2 of Montgomery limb values (k <= 17 terms),
        reduced mod p: integer column sum + carry + descending conditional
        subtracts of 2^j * p (branchless: borrow read off an extra limb)."""
        L = self.df.L
        k = terms.shape[-2]
        cols = terms.sum(dim=-2, dtype=torch.int32)
        x = carry_fix(cols, L + 1)
        jtop = max(0, (k - 1).bit_length() - 1) + 1  # 2^jtop >= k
        for jj in range(jtop, -1, -1):
            d = carry_fix(x - self._p_mults[jj], L + 2)
            borrow = d[..., L + 1] != 0
            x = torch.where(borrow.unsqueeze(-1), x, d[..., : L + 1])
        return x[..., :L]

    def _sbox(self, s: torch.Tensor) -> torch.Tensor:
        df = self.df
        return df.mul(df.square(df.square(s)), s)

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """state: (..., t, L) Montgomery -> permuted state.  A partial
        round raises element 0 alone to the fifth power; the reference
        raises all t and keeps element 0, the same limbs."""
        df = self.df
        s = state
        for c, full in zip(self.C, self.full_flags):
            s = df.add(s, c)
            if full:
                s = self._sbox(s)
            else:
                s = torch.cat([self._sbox(s[..., :1, :]), s[..., 1:, :]],
                              dim=-2)
            # mix: out[i] = sum_j M[i][j] * s[j]
            s = self._sum_mod(df.mul(self.M, s[..., None, :, :]))
        return s

    def hash(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs: (..., t-1, L) Montgomery -> (..., L)."""
        zero = inputs.new_zeros(inputs.shape[:-2] + (1, self.df.L))
        state = torch.cat([zero, inputs], dim=-2)
        return self.permute(state)[..., 0, :]

    # host boundary helpers
    def hash_ints(self, rows: list[list[int]]) -> list[int]:
        spec = self.spec
        flat = [v * spec.r % spec.p for row in rows for v in row]
        arr = self._t(spec.batch_to_limbs(flat)).reshape(
            len(rows), self.t - 1, self.df.L)
        return self.df.decode(self.hash(arr))


def get_device_poseidon(t: int, spec=F.bn254_fr, device="cuda") -> DevicePoseidon:
    """The DevicePoseidon of arity t - 1 on `device`, made once per
    (t, spec, device)."""
    return _device_poseidon(t, spec, torch.device(device))


@functools.cache
def _device_poseidon(t, spec, device) -> DevicePoseidon:
    return DevicePoseidon(t, spec, device)
