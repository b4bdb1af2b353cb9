"""Content-addressed election metadata: CID computation + local provider.

Role parity: reference metadata/ (cid.go:25-46 CID computation, local KV
provider; the Pinata/IPFS pinning provider is an external-service client
and is represented by the same Provider interface here).

CIDs are IPFS CIDv1 with the raw codec and sha2-256 multihash, base32
multibase ("b..."), matching what `ipfs add --cid-version 1 --raw-leaves`
produces for small payloads.
"""

from __future__ import annotations

import hashlib
import json

_B32_ALPHABET = "abcdefghijklmnopqrstuvwxyz234567"


def _base32_lower_nopad(data: bytes) -> str:
    import base64

    return base64.b32encode(data).decode().lower().rstrip("=")


def compute_cid(data: bytes) -> str:
    """CIDv1(raw, sha2-256) with multibase base32."""
    mh = b"\x12\x20" + hashlib.sha256(data).digest()
    cid_bytes = b"\x01\x55" + mh
    return "b" + _base32_lower_nopad(cid_bytes)


class LocalMetadataProvider:
    """KV-backed metadata store addressed by CID."""

    def __init__(self, storage):
        self.storage = storage

    def publish(self, metadata: dict) -> str:
        data = json.dumps(metadata, sort_keys=True).encode()
        cid = compute_cid(data)
        self.storage.put_data("metadata", cid.encode(), data)
        return cid

    def fetch(self, cid: str) -> dict | None:
        raw = self.storage.get_data("metadata", cid.encode())
        if raw is None:
            return None
        if compute_cid(raw) != cid:
            return None  # integrity check
        return json.loads(raw)
