"""Contract-call ABI helpers on top of web3.encoding's encoder: signature
parsing, event topics, and DECODING (go-ethereum `abi.ABI.Unpack` role —
the reference unpacks every view-call return and event payload,
web3/contracts.go:594-646).  Types supported match encoding.abi_encode.
"""

from __future__ import annotations

from davinci_tpu_torch.ethereum import keccak256
from davinci_tpu_torch.web3.encoding import abi_encode, function_selector


def _split_types(sig_args: str) -> list[str]:
    out, depth, cur = [], 0, ""
    for ch in sig_args:
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
            continue
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        cur += ch
    if cur:
        out.append(cur)
    return out


def sig_types(sig: str) -> list[str]:
    """'f(uint256,bytes)' -> ['uint256', 'bytes']."""
    inner = sig[sig.index("(") + 1 : sig.rindex(")")]
    return _split_types(inner) if inner else []


selector = function_selector


def event_topic(sig: str) -> bytes:
    return keccak256(sig.encode())


def _norm(t: str, v):
    if t == "address" and isinstance(v, str):
        return int(v, 16)
    return v


def encode_args(types: list[str], args: list) -> bytes:
    return abi_encode(types, [_norm(t, v) for t, v in zip(types, args)])


def encode_call(sig: str, args: list) -> bytes:
    types = sig_types(sig)
    return selector(sig) + encode_args(types, args)


def _is_dynamic(t: str) -> bool:
    return t in ("bytes", "string") or t.endswith("[]")


def _dec_static(t: str, word: bytes):
    if t.startswith("uint"):
        return int.from_bytes(word, "big")
    if t.startswith("int"):
        return int.from_bytes(word, "big", signed=True)
    if t == "address":
        return "0x" + word[12:].hex()
    if t == "bool":
        return bool(int.from_bytes(word, "big"))
    if t.startswith("bytes") and t != "bytes":
        return word[: int(t[5:])]
    raise ValueError(t)


def decode_args(types: list[str], data: bytes) -> list:
    out = []
    for i, t in enumerate(types):
        word = data[32 * i : 32 * i + 32]
        if _is_dynamic(t):
            off = int.from_bytes(word, "big")
            n = int.from_bytes(data[off : off + 32], "big")
            if t in ("bytes", "string"):
                b = data[off + 32 : off + 32 + n]
                out.append(b.decode() if t == "string" else b)
            else:
                et = t[:-2]
                assert not _is_dynamic(et), "nested dynamic unsupported"
                out.append(
                    [
                        _dec_static(et, data[off + 32 + 32 * j :][:32])
                        for j in range(n)
                    ]
                )
        else:
            out.append(_dec_static(t, word))
    return out
