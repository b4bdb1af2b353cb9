"""The census signer (`csp.py`, whose key schedule and nonces run on
`hash/blake512.py`), the DKG (`dkg.py`) and the metadata CIDs
(`metadata.py`) of davinci_tpu_torch held against the JAX package's on
the CPU, on the same seeds: BLAKE-512 digests (the official vectors and
every length across a block edge), `BabyJubJubEdDSA(b"census")`'s key,
signatures and census proofs, the iden3 key of a raw private key, the
DKG's shares, public key and threshold decryption, SECIES share
transport, and `compute_cid` with the local metadata provider of
tests/test_statesync.py.  Tolerance: exact equality of ints, points,
bytes and strings.
"""

import random

import pytest

from davinci_tpu import csp as rcsp
from davinci_tpu import dkg as rdkg
from davinci_tpu import metadata as rmetadata
from davinci_tpu.elgamal import encrypt_with_k as r_encrypt_with_k
from davinci_tpu.hash.blake512 import blake512 as rblake512
from davinci_tpu.storage import MemoryKV as RMemoryKV
from davinci_tpu.storage import Storage as RStorage
from davinci_tpu_torch import csp, dkg, metadata
from davinci_tpu_torch.elgamal import encrypt_with_k
from davinci_tpu_torch.elgamal.core import baby_step_giant_step
from davinci_tpu_torch.hash.blake512 import blake512
from davinci_tpu_torch.storage import MemoryKV, Storage


def _xy(pt):
    return (pt.x, pt.y)


def _sig(s):
    return (tuple(s.r8), s.s)


def _proof(p):
    return {k: _sig(v) if k == "signature" else v for k, v in p.items()}


@pytest.mark.parametrize("n", [0, 1, 111, 112, 127, 128, 129, 144, 300])
def test_blake512_matches_reference(n):
    data = random.Random(n).randbytes(n)
    assert blake512(data) == rblake512(data)
    assert len(blake512(data)) == 64


def test_blake512_official_vectors():
    assert blake512(b"\x00").hex().startswith("97961587f6d970faba6d2478")
    assert blake512(bytes(144)).hex().startswith("313717d608e9cf758dcb1eb0")


def test_census_signer_matches_reference():
    """The port's signer constructs (its key schedule needs BLAKE-512) and
    gives the reference's key, signatures and census proofs."""
    ours, ref = csp.BabyJubJubEdDSA(b"census"), rcsp.BabyJubJubEdDSA(b"census")
    assert ours.public == ref.public
    for msg in (0, 1, 123456789, (1 << 253) + 7):
        assert _sig(ours.sign(msg)) == _sig(ref.sign(msg))
    p = ours.generate_proof(process_id=77, address=0xABC, weight=3,
                            voter_index=2)
    assert _proof(p) == _proof(ref.generate_proof(
        process_id=77, address=0xABC, weight=3, voter_index=2))
    assert csp.BabyJubJubEdDSA.verify_proof(p)
    assert rcsp.BabyJubJubEdDSA.verify_proof(p)
    p["weight"] = 4
    assert not csp.BabyJubJubEdDSA.verify_proof(p)
    assert ours.census_root() == ref.census_root()


def test_iden3_raw_key_matches_reference():
    raw = bytes.fromhex(
        "0001020304050607080900010203040506070809000102030405060708090001")
    ours = csp.BabyJubJubEdDSA(b"", raw_key=raw)
    assert ours.public == rcsp.BabyJubJubEdDSA(b"", raw_key=raw).public
    assert ours.public[0] == int(
        "13277427435165878497778222415993513565335242147425444199013288"
        "855685581939618")


def _dkg_run(mod, encrypt):
    r = random.Random(11)
    ids = [1, 2, 3, 4, 5]
    parts, pk = mod.run_dkg(ids, threshold=3, rng=r)
    c1, c2 = encrypt(pk, 4242, r.randrange(1, 2**200))
    partials = {i: mod.partial_decrypt(parts[i].private_share, c1)
                for i in (2, 4, 5)}
    M = mod.combine_partials(partials, c2)
    M2 = mod.combine_partials({i: partials[i] for i in (2, 4)}, c2)
    return {"shares": [parts[i].private_share for i in ids],
            "public_key": _xy(pk), "c": [_xy(c1), _xy(c2)],
            "partials": {i: _xy(p) for i, p in partials.items()},
            "M": _xy(M), "M2": _xy(M2),
            "lagrange": [mod.lagrange_coeff(i, [2, 4, 5]) for i in (2, 4, 5)]}, M


def test_dkg_threshold_decrypt_matches_reference():
    got, M = _dkg_run(dkg, encrypt_with_k)
    want, _ = _dkg_run(rdkg, r_encrypt_with_k)
    assert got == want
    assert baby_step_giant_step(M, 10**5) == 4242
    assert got["M2"] != got["M"]


def test_dkg_bad_share_rejected_alike():
    msgs = []
    for mod in (dkg, rdkg):
        r = random.Random(12)
        ids = [1, 2, 3]
        parts = {i: mod.Participant(i, 2, ids) for i in ids}
        for p in parts.values():
            p.generate_polynomial(r)
            p.compute_shares()
        with pytest.raises(ValueError) as err:
            parts[1].receive_share(2, parts[2].shares_out[1] + 1,
                                   parts[2].public_coeffs)
        msgs.append((str(err.value), parts[2].shares_out))
    assert msgs[0] == msgs[1]


def test_secies_matches_reference():
    out = []
    for mod in (dkg, rdkg):
        rng = random.Random(99)
        priv, pub = mod.secies_keygen(rng)
        share = rng.randrange(1, 2**250)
        ct = mod.secies_encrypt(pub, share, rng)
        assert mod.secies_decrypt(priv, ct) == share
        other, _ = mod.secies_keygen(rng)
        with pytest.raises(ValueError):
            mod.secies_decrypt(other, ct)
        out.append((priv, _xy(pub), ct.ephemeral, ct.payload, ct.mac))
        ct.payload = (ct.payload + 1) % (1 << 250)
        with pytest.raises(ValueError):
            mod.secies_decrypt(priv, ct)
    assert out[0] == out[1]


def test_metadata_cid_matches_reference():
    """tests/test_statesync.py's metadata case on both packages."""
    meta = {"title": "Election", "questions": [{"t": "Q1"}]}
    ours = metadata.LocalMetadataProvider(Storage(MemoryKV()))
    ref = rmetadata.LocalMetadataProvider(RStorage(RMemoryKV()))
    cid = ours.publish(meta)
    assert cid == ref.publish(meta) and cid.startswith("b")
    assert ours.fetch(cid) == meta
    assert ours.fetch("b" + "a" * 58) is None
    for data in (b"hello", b"hello2", b""):
        assert metadata.compute_cid(data) == rmetadata.compute_cid(data)
    assert metadata.compute_cid(b"hello") != metadata.compute_cid(b"hello2")
