"""Vote verifier (circuit 2, BLS12-377): the per-vote recursion layer.

Statement (reference circuits/voteverifier/vote_verifier.go:71-110):
  public:  vote_hash = Poseidon_{BN254}(processID, address, voteID,
                                        inputs_hash) mod 2^252
           (the per-vote hash lives in the BN254 field so the
           state-transition circuit — which sees all 60 votes — recomputes
           it NATIVELY; this circuit pays the one-time emulated Poseidon)
  private: the circuit-1 ballot proof + its public input (the
           ballot-inputs hash), the voter's ECDSA public key + signature.
  checks:
    1. the circuit-1 Groth16 proof verifies under the baked-in inner VK
       (emulated inner-curve pairing: gnark sw_bn254 role);
    2. ECDSA signature over the EIP-191 message for the 32-byte voteID
       payload verifies (emulated secp256k1 + in-circuit keccak:
       verifySigForAddress role);
    3. address == keccak256(pubkey)[12:];
    4. voteID consistency with the address/processID binding carried in
       the public vote_hash.

Curve-parameterized: production uses inner=BN254 (circuit 1) and
sig=secp256k1; CI runs the identical composition with the toy curves
(circuits/toycurve.py) so the whole statement builds + checks in minutes.
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.circuits.algebra import assert_bits_lt_const
from davinci_tpu_torch.circuits.ecdsa_gadget import ECDSAGadget
from davinci_tpu_torch.circuits.keccak_gadget import (
    bytes_to_bits,
    keccak256_bits,
)
from davinci_tpu_torch.circuits.pairing_gadget import Groth16VerifierGadget
from davinci_tpu_torch.circuits.xfield_hash import emulated_poseidon
from davinci_tpu_torch.groth16.r1cs import ConstraintSystem
from davinci_tpu_torch.hash.poseidon import poseidon_hash

VOTE_HASH_BITS = 252  # truncation: the hash must embed in every chain field

ETH_PREFIX = b"\x19Ethereum Signed Message:\n32"


def witness_vote_hash(params, w) -> int:
    """The public vote hash under the params' hash mode."""
    if params.hash_native:
        return poseidon_hash(
            [w.process_id, w.address, w.vote_id, w.inputs_hash],
            p=params.native_r,
        ) & ((1 << VOTE_HASH_BITS) - 1)
    return w.vote_hash(params.hash_p)


@dataclass
class VoteVerifierWitness:
    process_id: int
    address: int          # 160-bit Ethereum address (integer)
    vote_id: int          # 64-bit protocol vote id
    inputs_hash: int      # circuit-1 public input (inner scalar field)
    ballot_proof: object  # groth16.Proof on the inner curve
    pubkey: object        # AffinePoint on the signature curve
    sig_r: int
    sig_s: int

    def vote_hash(self, hash_p: int) -> int:
        """Poseidon over the PER-VOTE hash field (BN254 in production),
        truncated so the value embeds in BLS12-377-Fr and BW6-761-Fr."""
        h = poseidon_hash(
            [self.process_id, self.address, self.vote_id, self.inputs_hash],
            p=hash_p,
        )
        return h & ((1 << VOTE_HASH_BITS) - 1)


@dataclass
class VoteVerifierParams:
    """Compile-time parameters: the inner proof system + signature curve."""

    inner_ctx: object     # PairingCtx of circuit 1's curve
    inner_vk: object      # circuit-1 VerifyingKey (baked constant)
    sig_spec: object      # CurveSpec for ECDSA (secp256k1 / toy g1)
    native_r: int = F.BLS12_377_R
    hash_p: int = F.BN254_R    # per-vote hash field (native in circuit 4)
    addr_bits: int = 160
    vote_id_bytes: int = 32
    sig_coord_bits: int = 256
    # CI pipeline-flow tier: drop the two heavyweight sub-statements (the
    # full composition is covered by tests/test_voteverifier_circuit.py);
    # production keeps both on.
    include_inner_proof: bool = True
    include_signature: bool = True
    # lite tier also hashes natively (production: emulated BN254 Poseidon
    # so circuit 4 recomputes the per-vote hash natively)
    hash_native: bool = False
    # range-check tier: lookup (Groth16 commitment extension, O(1)/chunk)
    # vs bit decomposition; lookup circuits prove via prove_committed
    use_lookup: bool = False

    def circuit_id(self) -> str:
        lite = ""
        if not self.include_inner_proof:
            lite += "-noinner"
        if not self.include_signature:
            lite += "-nosig"
        if self.hash_native:
            lite += "-nathash"
        if self.use_lookup:
            lite += "-lookup"
        return (
            f"voteverifier-{self.inner_ctx.name}-{self.sig_spec.name}{lite}-v1"
        )


def build_vote_verifier_circuit(
    params: VoteVerifierParams, w: VoteVerifierWitness,
    challenge: int = 0, blind: int = 0,
) -> ConstraintSystem:
    """challenge/blind: the two-phase commitment inputs when
    params.use_lookup (driven by Groth16.prove_committed)."""
    cs = ConstraintSystem(params.native_r)
    rc = None
    if params.use_lookup:
        from davinci_tpu_torch.circuits.lookup import LookupRangeChecker

        rc = LookupRangeChecker(cs, table_bits=12)

    # -- public ------------------------------------------------------------
    vote_hash_pub = cs.pub_input(witness_vote_hash(params, w))

    # -- private witness ---------------------------------------------------
    pid = cs.priv_input(w.process_id)
    addr = cs.priv_input(w.address)
    vote_id = cs.priv_input(w.vote_id)

    # -- 1. inner (ballot) proof verification ------------------------------
    ih_nbits = params.inner_ctx.r.bit_length()
    ih_bits = []
    for i in range(ih_nbits):
        b = cs.priv_input((w.inputs_hash >> i) & 1)
        cs.assert_bool(b)
        ih_bits.append(b)
    assert_bits_lt_const(cs, ih_bits, params.inner_ctx.r)
    if params.include_inner_proof:
        with cs.scope("inner-groth16"):
            from davinci_tpu_torch.circuits.emulated import EmulatedOps as _EOps

            base = (
                _EOps(cs, params.inner_ctx.p, range_checker=rc)
                if rc is not None and cs.p != params.inner_ctx.p
                else None
            )
            gadget = Groth16VerifierGadget(
                cs, params.inner_ctx, params.inner_vk, base_ops=base
            )
            proof_vars = gadget.alloc_proof(w.ballot_proof)
            gadget.assert_valid(proof_vars, [ih_bits])

    if params.include_signature:
        # -- 2. ECDSA over the EIP-191 voteID message ----------------------
        with cs.scope("ecdsa"):
            ecdsa = ECDSAGadget(cs, params.sig_spec, range_checker=rc)
            pub_pt = ecdsa.alloc_pubkey(w.pubkey)
            # voteID payload: 32-byte big-endian
            vid_bits = cs.to_bits(vote_id, 64)
            payload_bits = _int_bits_to_msg_bytes(
                cs, vid_bits, params.vote_id_bytes
            )
            msg = bytes_to_bits(cs, ETH_PREFIX) + payload_bits
            e_bits_msg = keccak256_bits(cs, msg)
            e_bits = _msg_bytes_to_int_bits(e_bits_msg)
            ecdsa.verify(pub_pt, w.sig_r, w.sig_s, e_bits)

        # -- 3. address binding --------------------------------------------
        with cs.scope("address"):
            addr_msg_bits = ecdsa.eth_address_bits(
                pub_pt, coord_bits=params.sig_coord_bits
            )
            addr_int_bits = _msg_bytes_to_int_bits(addr_msg_bits)
            acc = cs.constant(0)
            for i, b in enumerate(addr_int_bits):
                acc = acc + cs.coerce(b) * (1 << i)
            cs.assert_eq(acc, addr)

    # -- 4. public hash binding ---------------------------------------------
    if params.hash_native:
        with cs.scope("vote-hash-native"):
            ih_native = cs.from_bits(ih_bits)
            h = cs.poseidon([pid, addr, vote_id, ih_native])
            from davinci_tpu_torch.circuits import gadgets as G

            h_bits = G.to_bits_canonical(cs, h, params.native_r.bit_length())
            cs.assert_eq(cs.from_bits(h_bits[:VOTE_HASH_BITS]), vote_hash_pub)
        if rc is not None:
            rc.finalize(challenge, blind)
            cs._refinalize = rc.refinalize
        return cs

    # Poseidon over the BN254 hash field, emulated here (one per vote);
    # the state-transition circuit recomputes the same hash natively.
    with cs.scope("vote-hash"):
        from davinci_tpu_torch.circuits.emulated import EmulatedOps
        from davinci_tpu_torch.circuits.xfield_hash import native_value_to_emu

        Eh = EmulatedOps(cs, params.hash_p, range_checker=rc)
        pid_e = native_value_to_emu(cs, Eh, pid, params.native_r.bit_length() - 1)
        addr_e = native_value_to_emu(cs, Eh, addr, params.addr_bits)
        vid_e = native_value_to_emu(cs, Eh, vote_id, 64)
        ih_e = Eh.reduce(
            _bits_to_emuvar(cs, Eh, ih_bits)
        )
        h = emulated_poseidon(cs, Eh, [pid_e, addr_e, vid_e, ih_e])
        h_bits = Eh.to_canonical_bits(h)
        bound = cs.from_bits(h_bits[:VOTE_HASH_BITS])
        cs.assert_eq(bound, vote_hash_pub)

    if rc is not None:
        rc.finalize(challenge, blind)
        cs._refinalize = rc.refinalize
    return cs


def _bits_to_emuvar(cs, E, bits):
    """Boolean bits -> (unreduced) emulated element via limb regrouping."""
    from davinci_tpu_torch.circuits.emulated import EmuVar

    limbs = []
    for off in range(0, len(bits), E.w):
        chunk = bits[off : off + E.w]
        acc = cs.constant(0)
        for i, b in enumerate(chunk):
            acc = acc + cs.coerce(b) * (1 << i)
        limbs.append(acc)
    return EmuVar(limbs, (1 << E.w) - 1)


def _int_bits_to_msg_bytes(cs, int_bits, nbytes: int):
    """Little-endian value bits -> keccak byte-layout bits of the
    fixed-width big-endian byte string."""
    zero = cs.constant(0)
    padded = (list(int_bits) + [zero] * (nbytes * 8))[: nbytes * 8]
    out = []
    for j in range(nbytes):  # byte 0 = most significant
        out.extend(padded[8 * (nbytes - 1 - j) : 8 * (nbytes - j)])
    return out


def _msg_bytes_to_int_bits(msg_bits):
    """Keccak byte-layout bits -> little-endian integer bits (big-endian
    byte interpretation)."""
    nbytes = len(msg_bits) // 8
    out = []
    for j in reversed(range(nbytes)):  # least-significant byte first
        out.extend(msg_bits[8 * j : 8 * (j + 1)])
    return out


# -- host-side witness production (the sequencer/prove_vote role) -----------


def make_vote_verifier_witness(
    params: VoteVerifierParams,
    process_id: int,
    priv_sig_key: int,
    inputs_hash: int,
    ballot_proof,
    vote_id: int,
    sign_fn=None,
) -> VoteVerifierWitness:
    """Build the witness: derive the address from the key, sign the EIP-191
    voteID message.  sign_fn(priv, e_int) -> (r, s) defaults to generic
    ECDSA over params.sig_spec with deterministic nonce."""
    from davinci_tpu_torch.ethereum import keccak256

    spec = params.sig_spec
    pub = spec.gen.mul(priv_sig_key)
    nbytes = params.sig_coord_bits // 8
    addr = int.from_bytes(
        keccak256(
            pub.x.v.to_bytes(nbytes, "big") + pub.y.v.to_bytes(nbytes, "big")
        )[12:],
        "big",
    )
    payload = vote_id.to_bytes(params.vote_id_bytes, "big")
    e = int.from_bytes(keccak256(ETH_PREFIX + payload), "big")
    if sign_fn is None:
        sign_fn = lambda d, ev: _generic_sign(spec, d, ev)
    r, s = sign_fn(priv_sig_key, e)
    return VoteVerifierWitness(
        process_id=process_id,
        address=addr,
        vote_id=vote_id,
        inputs_hash=inputs_hash,
        ballot_proof=ballot_proof,
        pubkey=pub,
        sig_r=r,
        sig_s=s,
    )


def _generic_sign(spec, d: int, e: int):
    """Deterministic generic ECDSA sign over a prime-order subgroup."""
    import hashlib

    n = spec.r
    ctr = 0
    while True:
        k = (
            int.from_bytes(
                hashlib.sha512(
                    f"davinci-k|{d}|{e}|{ctr}".encode()
                ).digest(),
                "big",
            )
            % n
        )
        ctr += 1
        if k == 0:
            continue
        R = spec.gen.mul(k)
        r = R.x.v % n
        if r == 0:
            continue
        s = pow(k, -1, n) * (e + r * d) % n
        if s:
            return r, s
