"""In-circuit ECDSA verification over an emulated curve + Ethereum address
derivation.

Role parity: the reference vote verifier's in-circuit signature check
(circuits/voteverifier/vote_verifier.go:94-110 verifySigForAddress — gnark
std emulated ecdsa + sha3): verify sig(voteID) under the voter's secp256k1
key and bind keccak(pubkey)[12:] as the address.

Parameterized by curve so CI runs the identical code on a small curve
(circuits/toycurve.py g1) while full secp256k1 is exercised gated.
"""

from __future__ import annotations

from davinci_tpu_torch.circuits.algebra import WeierstrassGadget, aux_point
from davinci_tpu_torch.circuits.emulated import EmulatedOps
from davinci_tpu_torch.circuits.keccak_gadget import keccak256_bits


class ECDSAGadget:
    """Verify (r, s) over msg-hash bits with a witness public key."""

    def __init__(
        self, cs, curve_spec, aux_seed: str = "davinci-ecdsa-aux",
        range_checker=None,
    ):
        """curve_spec: host CurveSpec with prime-order subgroup (cofactor-1
        usage: secp256k1, or the toy curve's G1).  range_checker: optional
        lookup checker for the O(1)-per-chunk range-check tier."""
        self.cs = cs
        self.spec = curve_spec
        self.p = curve_spec.fld.p
        self.n = curve_spec.r
        self.Ep = EmulatedOps(cs, self.p, range_checker=range_checker)
        self.En = EmulatedOps(cs, self.n, range_checker=range_checker)
        self.curve = WeierstrassGadget(
            self.Ep, self.Ep.constant(curve_spec.b_ff.v)
        )
        self.nbits = self.n.bit_length()
        self._aux = aux_point(curve_spec, aux_seed)

    # -- allocation -----------------------------------------------------------

    def alloc_pubkey(self, pub):
        """Host AffinePoint -> gadget point with on-curve check."""
        P = self.curve.alloc_point(pub)
        self.curve.assert_on_curve(P)
        return P

    def _bits_to_emu(self, E: EmulatedOps, bits):
        """Boolean bits (LSB-first) -> canonical emulated element (reduced
        mod E.p).  Bits are already boolean-constrained by the caller."""
        from davinci_tpu_torch.circuits.emulated import EmuVar

        w = E.w
        limbs = []
        for off in range(0, len(bits), w):
            chunk = bits[off : off + w]
            acc = self.cs.constant(0)
            for i, b in enumerate(chunk):
                acc = acc + self.cs.coerce(b) * (1 << i)
            limbs.append(acc)
        wide = EmuVar(limbs, (1 << w) - 1)
        return E.reduce(wide)

    # -- verification ---------------------------------------------------------

    def verify(self, pub_point, r_val: int, s_val: int, msg_bits):
        """Assert ECDSA-valid: allocates r, s (canonical, nonzero) and
        checks x([u1]G + [u2]PK) == r mod n where u1 = e/s, u2 = r/s.

        msg_bits: the hash e as boolean bits, little-endian (bit i = e>>i
        &1 of the big-endian integer interpretation).  Returns (r, s) emu
        elements for further binding."""
        En, cs = self.En, self.cs
        r = En.alloc(r_val)
        s = En.alloc(s_val)
        # canonical < n and nonzero
        r_bits = En.to_canonical_bits(r)
        En.to_canonical_bits(s)
        En.inv(r)  # nonzero
        s_inv = En.inv(s)  # nonzero + inverse

        e = self._bits_to_emu(En, msg_bits)
        u1 = En.mul(e, s_inv)
        u2 = En.mul(r, s_inv)
        u1_bits = self._canonical_scalar_bits(u1)
        u2_bits = self._canonical_scalar_bits(u2)

        R = self.curve.msm_with_aux(
            [u1_bits, u2_bits],
            [self.spec.gen, pub_point],
            self._aux,
            self.nbits,
        )
        # x(R) mod n == r
        rx_bits = self.Ep.to_canonical_bits(R[0])
        rx_mod_n = self._bits_to_emu(En, rx_bits)
        En.assert_eq(rx_mod_n, r)
        return r, s

    def _canonical_scalar_bits(self, a):
        bits = self.En.to_canonical_bits(a)
        return bits[: self.nbits]

    # -- Ethereum address -----------------------------------------------------

    def eth_address_bits(self, pub_point, coord_bits: int = 256):
        """keccak256(x||y)[12:] as 160 address bits (LSB-first in the
        byte layout used by keccak256_bits).  coord_bits: byte-padded
        coordinate width (256 for secp256k1)."""
        xb = self.Ep.to_canonical_bits(pub_point[0])
        yb = self.Ep.to_canonical_bits(pub_point[1])

        def to_msg_bits(bits):
            # little-endian value bits -> big-endian byte string in the
            # keccak byte layout (per-byte LSB-first)
            nbytes = coord_bits // 8
            # canonical bits may exceed coord_bits (limb rounding); the
            # excess top bits are provably zero (value < p < 2^coord_bits)
            padded = (
                list(bits) + [self.cs.constant(0)] * coord_bits
            )[:coord_bits]
            out = []
            for j in range(nbytes):  # byte 0 = most significant
                byte_bits = padded[8 * (nbytes - 1 - j) : 8 * (nbytes - j)]
                out.extend(byte_bits)
            return out

        msg = to_msg_bits(xb) + to_msg_bits(yb)
        digest = keccak256_bits(self.cs, msg)
        # digest is 32 bytes (byte layout); address = bytes 12..31
        return digest[12 * 8 :]
