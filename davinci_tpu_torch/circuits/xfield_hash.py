"""Cross-field Poseidon: the Poseidon permutation of ANOTHER field's
instance evaluated in-circuit through emulated arithmetic.

Why it exists: the recursion chain hashes in each circuit's native field —
circuit 3's public batch hash is a BW6-761-Fr MultiPoseidon — and the next
circuit up (the BN254 state transition) must RECOMPUTE that hash from its
own witness data to bind the two proofs together (reference
circuits/statetransition/statetransition.go VerifyAggregatorProof +
inputs binding).  Cost control: the S-box is 3 emulated muls; the MDS
matrix row is ONE EmulatedOps.lincomb (single carry check), which is what
makes this affordable.
"""

from __future__ import annotations

from davinci_tpu_torch.circuits.emulated import EmulatedOps, EmuVar
from davinci_tpu_torch.hash.poseidon import N_ROUNDS_P, R_F, poseidon_constants


def emulated_poseidon(cs, E: EmulatedOps, inputs: list) -> EmuVar:
    """Poseidon (circomlib shape) over the emulated field E; inputs are
    EmuVars; returns state[0]."""
    t = len(inputs) + 1
    assert 1 <= len(inputs) <= 16
    Cc, M = poseidon_constants(t, E.p)
    r_p = N_ROUNDS_P[t - 2]
    half = R_F // 2
    state = [E.zero] + list(inputs)
    ctr = 0

    def sbox5(x):
        x2 = E.square(x)
        x4 = E.square(x2)
        return E.mul(x4, x)

    for r in range(R_F + r_p):
        state = [
            E.add(s, E.constant(Cc[ctr + i])) for i, s in enumerate(state)
        ]
        ctr += t
        if r < half or r >= half + r_p:
            state = [sbox5(x) for x in state]
        else:
            state = [sbox5(state[0])] + state[1:]
        state = [
            E.lincomb([(state[j], M[i][j]) for j in range(t)])
            for i in range(t)
        ]
    return state[0]


def emulated_multi_poseidon(cs, E: EmulatedOps, inputs: list) -> EmuVar:
    """Chunk-of-16 multihash mirroring hash.poseidon.multi_poseidon."""
    assert inputs
    if len(inputs) <= 16:
        return emulated_poseidon(cs, E, inputs)
    hashes = [
        emulated_poseidon(cs, E, inputs[i : i + 16])
        for i in range(0, len(inputs), 16)
    ]
    if len(hashes) == 1:
        return hashes[0]
    if len(hashes) <= 16:
        return emulated_poseidon(cs, E, hashes)
    return emulated_multi_poseidon(cs, E, hashes)


def native_value_to_emu(cs, E: EmulatedOps, v, nbits: int) -> EmuVar:
    """Bind a native circuit value (< 2^nbits <= native field) as an
    emulated element of a LARGER field: bit-decompose natively, regroup the
    bits into emulated limbs (linear, exact since 2^nbits < E.p)."""
    assert (1 << nbits) <= E.p, "value range must embed injectively"
    bits = cs.to_bits(cs.coerce(v), nbits)
    limbs = []
    for off in range(0, nbits, E.w):
        chunk = bits[off : off + E.w]
        acc = cs.constant(0)
        for i, b in enumerate(chunk):
            acc = acc + b * (1 << i)
        limbs.append(acc)
    return EmuVar(limbs, (1 << E.w) - 1)
