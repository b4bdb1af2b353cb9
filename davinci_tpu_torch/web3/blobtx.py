"""EIP-4844 type-3 (blob) transaction construction and signing.

Role parity: reference web3/blobs.go:61-166 (blob tx assembly with sidecar)
— the on-chain submission vehicle for state-transition batches.

Encoding: per EIP-4844, the signing payload is
  keccak256(0x03 || rlp([chain_id, nonce, max_priority_fee, max_fee, gas,
  to, value, data, access_list, max_fee_per_blob_gas, blob_versioned_hashes]))
and the network form appends the sidecar (blobs, commitments, proofs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from davinci_tpu_torch import ethereum as eth
from davinci_tpu_torch.blobs import versioned_hash
from davinci_tpu_torch.web3.encoding import rlp_encode

BLOB_TX_TYPE = 3

# EIP-4844 sidecar versions (reference types/blobs.go:90-162): version 0
# carries one blob proof per blob; version 1 (EIP-7594 / Fusaka) carries
# 128 cell proofs per blob.
SIDECAR_VERSION_0 = 0
SIDECAR_VERSION_1 = 1
CELL_PROOFS_PER_BLOB = 128


@dataclass
class BlobTx:
    chain_id: int
    nonce: int
    max_priority_fee: int
    max_fee: int
    gas: int
    to: bytes               # 20 bytes
    value: int
    data: bytes
    max_fee_per_blob_gas: int
    blob_versioned_hashes: list
    access_list: list = field(default_factory=list)
    # signature
    v: int = None
    r: int = None
    s: int = None
    # sidecar
    blobs: list = field(default_factory=list)
    commitments: list = field(default_factory=list)
    proofs: list = field(default_factory=list)
    sidecar_version: int = SIDECAR_VERSION_0

    def _payload_fields(self):
        return [
            self.chain_id,
            self.nonce,
            self.max_priority_fee,
            self.max_fee,
            self.gas,
            self.to,
            self.value,
            self.data,
            self.access_list,
            self.max_fee_per_blob_gas,
            self.blob_versioned_hashes,
        ]

    def signing_hash(self) -> bytes:
        return eth.keccak256(
            bytes([BLOB_TX_TYPE]) + rlp_encode(self._payload_fields())
        )

    def encode_signed(self) -> bytes:
        assert self.v is not None, "unsigned"
        return bytes([BLOB_TX_TYPE]) + rlp_encode(
            self._payload_fields() + [self.v, self.r, self.s]
        )

    def tx_hash(self) -> bytes:
        return eth.keccak256(self.encode_signed())

    def validate_sidecar(self) -> None:
        """Structural sidecar checks mirroring the reference's submission
        guard (sequencer/onchain.go:162-173): version-matched proof counts."""
        nb = len(self.blobs)
        if len(self.commitments) != nb:
            raise ValueError("sidecar: commitment count != blob count")
        if self.sidecar_version == SIDECAR_VERSION_0:
            want = nb
        elif self.sidecar_version == SIDECAR_VERSION_1:
            want = nb * CELL_PROOFS_PER_BLOB
        else:
            raise ValueError(
                f"sidecar: unknown version {self.sidecar_version}"
            )
        if len(self.proofs) != want:
            raise ValueError(
                f"sidecar v{self.sidecar_version}: got {len(self.proofs)} "
                f"proofs, expected {want}"
            )

    def encode_network(self) -> bytes:
        """Network (pooled-transaction) form: the signed payload wrapped with
        the sidecar — version 1 prepends the version byte per EIP-7594."""
        self.validate_sidecar()
        wrapper = [
            self._payload_fields() + [self.v, self.r, self.s],
            self.blobs,
            self.commitments,
            self.proofs,
        ]
        body = rlp_encode(wrapper)
        if self.sidecar_version == SIDECAR_VERSION_1:
            return bytes([BLOB_TX_TYPE, SIDECAR_VERSION_1]) + body
        return bytes([BLOB_TX_TYPE]) + body


def build_blob_tx(
    chain_id: int,
    nonce: int,
    to: bytes,
    data: bytes,
    blobs_with_kzg: list,
    max_fee: int = 50 * 10**9,
    max_priority_fee: int = 2 * 10**9,
    max_fee_per_blob_gas: int = 10**9,
    gas: int = 500_000,
    sidecar_version: int = SIDECAR_VERSION_0,
) -> BlobTx:
    """blobs_with_kzg: list of (blob_bytes, commitment48, proofs) where
    proofs is one 48-byte blob proof (version 0) or the list of 128 cell
    proofs (version 1, EIP-7594)."""
    hashes = [versioned_hash(c) for _, c, _ in blobs_with_kzg]
    flat_proofs: list = []
    for _, _, p in blobs_with_kzg:
        if isinstance(p, (list, tuple)):
            flat_proofs.extend(p)
        else:
            flat_proofs.append(p)
    return BlobTx(
        chain_id=chain_id,
        nonce=nonce,
        max_priority_fee=max_priority_fee,
        max_fee=max_fee,
        gas=gas,
        to=to,
        value=0,
        data=data,
        max_fee_per_blob_gas=max_fee_per_blob_gas,
        blob_versioned_hashes=hashes,
        blobs=[b for b, _, _ in blobs_with_kzg],
        commitments=[c for _, c, _ in blobs_with_kzg],
        proofs=flat_proofs,
        sidecar_version=sidecar_version,
    )


def sign_blob_tx(tx: BlobTx, priv: int) -> BlobTx:
    r, s, rec = eth.sign(priv, tx.signing_hash())
    tx.v, tx.r, tx.s = rec & 1, r, s
    return tx


def sender_of(tx: BlobTx) -> bytes | None:
    """Recover the sender address (verification oracle for tests)."""
    pub = eth.recover(tx.signing_hash(), tx.r, tx.s, tx.v)
    return eth.address_from_pubkey(pub) if pub else None
