"""Aggregator (circuit 3, BW6-761): recursively verifies up to
VOTES_PER_BATCH vote-verifier proofs (BLS12-377) with dummy padding.

Statement (reference circuits/aggregator/aggregator.go:18-56, FillWithDummy
helpers.go:19-30, canonical dummy voteverifier/dummy.go:14-60):
  public:  batch_hash = keccak256(count_byte || masked vote hashes as
           32-byte words)[:31 bytes]  — keccak because it is a BOOLEAN
           circuit, equally cheap natively here (BW6) and in the BN254
           state-transition circuit that must recompute it; a Poseidon
           batch hash would force multi-million-constraint emulated
           arithmetic on one side or the other.
  private: N vote hashes, N proofs, the latch mask.
  checks:
    * mask bits are boolean and non-increasing (real votes form a prefix —
      the reference's latch, aggregator.go:27);
    * valid_count == sum(mask);
    * EVERY slot's proof verifies under the vote-verifier VK against that
      slot's public vote hash (dummy slots carry the canonical dummy proof
      + dummy hash — real proofs of the dummy witness, exactly the
      reference's padding model);
    * the public batch hash binds count + masked hashes.

This is NATIVE recursion: BW6-761's scalar field is BLS12-377's base
field, so the in-circuit pairing costs ~20k constraints per proof — the
whole reason the 2-chain exists.
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch import spec as protocol
from davinci_tpu_torch.circuits.keccak_gadget import keccak256_bits
from davinci_tpu_torch.circuits.pairing_gadget import Groth16VerifierGadget
from davinci_tpu_torch.groth16.r1cs import ConstraintSystem
from davinci_tpu_torch.pairing import bls377_pairing

BATCH_HASH_BYTES = 31  # truncated keccak digest (embeds in every field)


@dataclass
class AggregatorParams:
    inner_vk: object          # vote-verifier VerifyingKey (BLS12-377)
    dummy_proof: object       # canonical padding proof (valid!)
    dummy_public: int         # its public vote hash
    n_votes: int = protocol.VOTES_PER_BATCH
    native_r: int = F.BW6_761_R
    # inner proofs carry the Pedersen commitment extension (the lookup-tier
    # vote verifier proves via Groth16.prove_committed): verify PoK +
    # challenge + D per slot (gnark std/recursion with-commitment role)
    inner_committed: bool = False
    # inner curve pairing ctx (None = BLS12-377; the toy 2-chain's inner
    # for full-recursion CI, circuits/toycurve.toy_bls12_2chain)
    inner_ctx: object = None
    # truncated-digest width; must embed in native_r (31 bytes fits the
    # 377-bit BW6-761 Fr; toy outer fields are narrower)
    hash_bytes: int = BATCH_HASH_BYTES

    def circuit_id(self) -> str:
        com = "-com" if self.inner_committed else ""
        ctx = (
            f"-{self.inner_ctx.name}" if self.inner_ctx is not None else ""
        )
        return f"aggregator-{self.n_votes}{com}{ctx}-v1"


@dataclass
class AggregatorWitness:
    vote_hashes: list         # real slots only (len = valid count)
    proofs: list              # matching proofs

    def padded(self, params: AggregatorParams):
        n = params.n_votes
        assert len(self.proofs) <= n
        vh = list(self.vote_hashes) + [params.dummy_public] * (
            n - len(self.vote_hashes)
        )
        pf = list(self.proofs) + [params.dummy_proof] * (n - len(self.proofs))
        mask = [1] * len(self.proofs) + [0] * (n - len(self.proofs))
        return vh, pf, mask


def batch_hash(params: AggregatorParams, witness: AggregatorWitness) -> int:
    """Host oracle: keccak256(count || masked 32-byte vote hashes)[:31]."""
    from davinci_tpu_torch.ethereum import keccak256

    vh, _, mask = witness.padded(params)
    data = bytes([len(witness.proofs)]) + b"".join(
        (h if m else 0).to_bytes(32, "big") for h, m in zip(vh, mask)
    )
    return int.from_bytes(keccak256(data)[: params.hash_bytes], "big")


def build_aggregator_circuit(
    params: AggregatorParams, witness: AggregatorWitness
) -> ConstraintSystem:
    cs = ConstraintSystem(params.native_r)
    bh_pub = cs.pub_input(batch_hash(params, witness))

    vh_vals, proofs, mask_vals = witness.padded(params)
    mask = []
    with cs.scope("vote-mask"):
        for m in mask_vals:
            b = cs.priv_input(m)
            cs.assert_bool(b)
            mask.append(b)
        # latch: once off, stays off (mask[i+1] <= mask[i])
        for i in range(len(mask) - 1):
            cs.assert_eq(cs.mul(mask[i + 1], cs.one - mask[i]), cs.constant(0))
        count = cs.constant(0)
        for b in mask:
            count = count + b

    gadget = Groth16VerifierGadget(
        cs, params.inner_ctx or bls377_pairing, params.inner_vk
    )
    masked_bits = []
    for i in range(params.n_votes):
        with cs.scope(f"verify-{i}"):
            vh = cs.priv_input(vh_vals[i])
            bits = gadget.scalar_bits_from_native(vh)
            if params.inner_committed:
                pv = gadget.alloc_committed_proof(proofs[i])
                gadget.assert_valid_committed(pv, [bits])
            else:
                pv = gadget.alloc_proof(proofs[i])
                gadget.assert_valid(pv, [bits])
            masked_bits.append([cs.mul(mask[i], b) for b in bits])

    with cs.scope("batch-hash"):
        # count is < 256 (one byte); bind its byte plus each masked hash
        # as a 32-byte big-endian word into the keccak message
        count_bits = cs.to_bits(count, 8)
        msg = _value_bits_to_bytes(cs, count_bits, 1)
        for bits in masked_bits:
            msg += _value_bits_to_bytes(cs, bits, 32)
        digest = keccak256_bits(cs, msg)
        bound = _bytes_bits_to_value(cs, digest[: params.hash_bytes * 8])
        cs.assert_eq(bound, bh_pub)
    return cs


def _value_bits_to_bytes(cs, bits, nbytes: int):
    """Little-endian value bits -> keccak byte-layout bits of the big-endian
    byte string."""
    zero = cs.constant(0)
    padded = (list(bits) + [zero] * (nbytes * 8))[: nbytes * 8]
    out = []
    for j in range(nbytes):
        out.extend(padded[8 * (nbytes - 1 - j) : 8 * (nbytes - j)])
    return out


def _bytes_bits_to_value(cs, msg_bits):
    """Keccak byte-layout bits -> the big-endian integer as a LinComb."""
    nbytes = len(msg_bits) // 8
    acc = cs.constant(0)
    w = 0
    for j in reversed(range(nbytes)):
        for i in range(8):
            acc = acc + cs.coerce(msg_bits[8 * j + i]) * (1 << (w))
            w += 1
    return acc
