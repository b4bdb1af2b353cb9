"""Ethereum wire encodings: RLP and (a practical subset of) ABI.

Role parity: the go-ethereum encoding machinery behind the reference's
web3/contracts.go bindings and solidity/solidity.go proof encoding.
Covers what the node needs: static tuples, uint256/address/bytes32,
dynamic bytes and arrays, nested tuples for Groth16 proof submission.
"""

from __future__ import annotations

from davinci_tpu_torch.ethereum import keccak256

# ---------------------------------------------------------------------------
# RLP
# ---------------------------------------------------------------------------


def rlp_encode(item) -> bytes:
    """item: bytes | int | list (recursively)."""
    if isinstance(item, int):
        if item == 0:
            payload = b""
        else:
            payload = item.to_bytes((item.bit_length() + 7) // 8, "big")
        return rlp_encode(payload)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_len(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _rlp_len(len(payload), 0xC0) + payload
    raise TypeError(type(item))


def _rlp_len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


# ---------------------------------------------------------------------------
# ABI
# ---------------------------------------------------------------------------


def rlp_decode(data: bytes):
    """Inverse of rlp_encode: bytes -> bytes | list (ints stay bytes —
    callers int.from_bytes as needed).  Used by the local fake node to
    decode the exact wire transactions the bindings produce."""
    item, rest = _rlp_decode_one(memoryview(data))
    assert not len(rest), "trailing rlp bytes"
    return item


def _rlp_decode_one(mv):
    assert len(mv), "empty rlp"
    b0 = mv[0]
    if b0 < 0x80:
        return bytes(mv[:1]), mv[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        return bytes(mv[1 : 1 + n]), mv[1 + n :]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(mv[1 : 1 + ln], "big")
        return bytes(mv[1 + ln : 1 + ln + n]), mv[1 + ln + n :]
    if b0 < 0xF8:
        n = b0 - 0xC0
        body, rest = mv[1 : 1 + n], mv[1 + n :]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(mv[1 : 1 + ln], "big")
        body, rest = mv[1 + ln : 1 + ln + n], mv[1 + ln + n :]
    items = []
    while len(body):
        item, body = _rlp_decode_one(body)
        items.append(item)
    return items, rest


def function_selector(signature: str) -> bytes:
    return keccak256(signature.encode())[:4]


def _fixed_array(typ):
    """`T[N]` -> ([T]*N as a tuple type) or None.  Fixed-size arrays
    encode exactly like an N-tuple of the element type."""
    if not isinstance(typ, str) or not typ.endswith("]") or typ.endswith("[]"):
        return None
    base, _, n = typ[:-1].rpartition("[")
    if not n.isdigit():
        return None
    return [base] * int(n)


def _is_dynamic(typ) -> bool:
    if isinstance(typ, list):  # tuple
        return any(_is_dynamic(t) for t in typ)
    fa = _fixed_array(typ)
    if fa is not None:
        return _is_dynamic(fa)
    if typ.endswith("[]") or typ in ("bytes", "string"):
        return True
    return False


def _enc_static(typ, val) -> bytes:
    if typ == "address":
        v = val if isinstance(val, int) else int.from_bytes(val, "big")
        return v.to_bytes(32, "big")
    if typ.startswith("uint") or typ.startswith("int"):
        return (int(val) % 2**256).to_bytes(32, "big")
    if typ == "bool":
        return int(bool(val)).to_bytes(32, "big")
    if typ.startswith("bytes") and typ != "bytes":
        n = int(typ[5:])
        b = bytes(val)
        assert len(b) == n
        return b + b"\x00" * (32 - n)
    raise TypeError(typ)


def abi_encode(types: list, values: list) -> bytes:
    """Standard head/tail ABI encoding.  A type is a string or a list of
    types (= tuple)."""
    assert len(types) == len(values)
    # normalize fixed-size arrays into tuples of the element type
    types = [(_fixed_array(t) or t) for t in types]
    heads, tails = [], []
    # compute head size first
    head_size = 0
    for t in types:
        if _is_dynamic(t):
            head_size += 32
        elif isinstance(t, list):
            head_size += 32 * _static_words(t)
        else:
            head_size += 32

    offset = head_size
    for t, v in zip(types, values):
        if _is_dynamic(t):
            tail = _enc_tail(t, v)
            heads.append(offset.to_bytes(32, "big"))
            tails.append(tail)
            offset += len(tail)
        elif isinstance(t, list):
            heads.append(abi_encode(t, list(v)))
        else:
            heads.append(_enc_static(t, v))
    return b"".join(heads) + b"".join(tails)


def _static_words(types: list) -> int:
    n = 0
    for t in types:
        if isinstance(t, list):
            n += _static_words(t)
        else:
            n += 1
    return n


def _enc_tail(typ, val) -> bytes:
    if typ in ("bytes", "string"):
        b = val.encode() if isinstance(val, str) else bytes(val)
        pad = (-len(b)) % 32
        return len(b).to_bytes(32, "big") + b + b"\x00" * pad
    if isinstance(typ, str) and typ.endswith("[]"):
        inner = typ[:-2]
        out = len(val).to_bytes(32, "big")
        out += abi_encode([inner] * len(val), list(val))
        return out
    if isinstance(typ, list):
        return abi_encode(typ, list(val))
    raise TypeError(typ)


def encode_call(signature: str, types: list, values: list) -> bytes:
    return function_selector(signature) + abi_encode(types, values)


# ---------------------------------------------------------------------------
# Groth16 proof tuples for the on-chain verifiers
# ---------------------------------------------------------------------------
#
# Role parity: reference solidity/solidity.go:15-116 — gnark bn254 proofs
# (plus the commitment extension's D/PoK points) flattened into the ABI
# tuple layout the Solidity verifiers consume.


def groth16_proof_tuple(proof) -> list:
    """Proof -> [Ax, Ay, Bx0, Bx1, By0, By1, Cx, Cy] (uint256 words).
    G2 coordinates use the (imaginary, real) word order Ethereum's
    pairing precompile expects."""
    ax, ay = int(proof.a.x.v), int(proof.a.y.v)
    bx = proof.b.x.v
    by = proof.b.y.v
    bx0, bx1 = (int(bx[0]), int(bx[1])) if isinstance(bx, tuple) else (int(bx), 0)
    by0, by1 = (int(by[0]), int(by[1])) if isinstance(by, tuple) else (int(by), 0)
    cx, cy = int(proof.c.x.v), int(proof.c.y.v)
    return [ax, ay, bx1, bx0, by1, by0, cx, cy]


def groth16_commitment_proof_tuple(proof) -> list:
    """CommittedProof -> proof words + [Dx, Dy, PoKx, PoKy] (reference
    Groth16CommitmentProof encoding, solidity/solidity.go:28+)."""
    base = groth16_proof_tuple(proof)
    return base + [
        int(proof.d.x.v), int(proof.d.y.v),
        int(proof.pok.x.v), int(proof.pok.y.v),
    ]


def encode_proof_calldata(proof, public_inputs: list) -> bytes:
    """ABI-encode (proof words, publics) for a verifier call."""
    words = (
        groth16_commitment_proof_tuple(proof)
        if getattr(proof, "d", None) is not None
        else groth16_proof_tuple(proof)
    )
    types = [f"uint256[{len(words)}]", f"uint256[{len(public_inputs)}]"]
    return abi_encode(types, [words, [int(x) for x in public_inputs]])
