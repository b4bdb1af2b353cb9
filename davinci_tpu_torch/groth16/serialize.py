"""Binary serialization for Groth16 proving/verifying keys and proofs.

Role parity: gnark's CCS/PK/VK WriteTo/ReadFrom used by the reference's
artifact cache (circuits/artifacts.go:62-106 hash-checked files on disk)
and the solidity/JSON proof encodings.  Format is fixed-width big-endian
per curve (field byte length from the curve's base field), so files are
deterministic and hashable.
"""

from __future__ import annotations

import hashlib
import io

import numpy as np

from davinci_tpu_torch.curves import AffinePoint
from davinci_tpu_torch.groth16.bases import EncodedBases
from davinci_tpu_torch.towers import FF

# v3: PK MSM bases are raw little-endian int32 limb-array blobs
# (EncodedBases) instead of per-point bignum records — (de)serializing
# multi-million-point keys through AffinePoints cost minutes per load
_MAGIC = b"DVTPU3\n"


def _write_arr(buf, a, dtype):
    a = np.ascontiguousarray(np.asarray(a, np.dtype(dtype).newbyteorder("<")))
    buf.write(len(a.shape).to_bytes(1, "big"))
    for d in a.shape:
        buf.write(int(d).to_bytes(8, "big"))
    buf.write(a.tobytes())


def _read_arr(buf, dtype):
    ndim = buf.read(1)[0]
    shape = tuple(
        int.from_bytes(buf.read(8), "big") for _ in range(ndim)
    )
    count = 1
    for d in shape:
        count *= d
    dt = np.dtype(dtype).newbyteorder("<")
    arr = np.frombuffer(buf.read(count * dt.itemsize), dt).reshape(shape)
    return arr.astype(dtype)


def _write_bases(buf, b: EncodedBases | None):
    if b is None:
        buf.write(b"\x00")
        return
    buf.write(b"\x01")
    for a in (b.x, b.y, b.z):
        _write_arr(buf, a, np.int32)


def _read_bases(buf) -> EncodedBases | None:
    if buf.read(1) == b"\x00":
        return None
    x = _read_arr(buf, np.int32)
    y = _read_arr(buf, np.int32)
    z = _read_arr(buf, np.int32)
    return EncodedBases(x, y, z)


def _write_idx(buf, idx):
    if idx is None:
        buf.write(b"\x00")
        return
    buf.write(b"\x01")
    _write_arr(buf, np.asarray(idx, np.int64), np.int64)


def _read_idx(buf):
    if buf.read(1) == b"\x00":
        return None
    return _read_arr(buf, np.int64)


def _field_nbytes(spec) -> int:
    return (spec.field_spec.p.bit_length() + 7) // 8


def _coord_components(v) -> tuple:
    """Field value -> tuple of int components (1 for Fp, 2 for Fp2)."""
    if isinstance(v, tuple):
        return tuple(int(c) for c in v)
    return (int(v),)


def _write_point(buf, pt: AffinePoint, nbytes: int, ncomp: int):
    if pt.infinity:
        buf.write(b"\x00")
        buf.write(b"\x00" * (2 * ncomp * nbytes))
        return
    buf.write(b"\x01")
    for coord in (pt.x.v, pt.y.v):
        comps = _coord_components(coord)
        assert len(comps) == ncomp
        for c in comps:
            buf.write(c.to_bytes(nbytes, "big"))


def _read_point(buf, spec, nbytes: int, ncomp: int) -> AffinePoint:
    flag = buf.read(1)[0]
    raw = buf.read(2 * ncomp * nbytes)
    if flag == 0:
        return AffinePoint(spec, None, None)
    vals = [
        int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "big")
        for i in range(2 * ncomp)
    ]
    fld = spec.fld
    if ncomp == 1:
        return AffinePoint(spec, fld(vals[0]), fld(vals[1]))
    x = FF(fld, (vals[0], vals[1]))
    y = FF(fld, (vals[2], vals[3]))
    return AffinePoint(spec, x, y)


def _ncomp(spec) -> int:
    return 1 if hasattr(spec.fld, "p") else 2


def _write_points(buf, pts, spec):
    nb, nc = _field_nbytes(spec), _ncomp(spec)
    buf.write(len(pts).to_bytes(8, "big"))
    for p in pts:
        _write_point(buf, p, nb, nc)


def _read_points(buf, spec) -> list:
    nb, nc = _field_nbytes(spec), _ncomp(spec)
    n = int.from_bytes(buf.read(8), "big")
    return [_read_point(buf, spec, nb, nc) for _ in range(n)]


def pk_to_bytes(pk, g1spec, g2spec) -> bytes:
    buf = io.BytesIO()
    write_pk(buf, pk, g1spec, g2spec)
    return buf.getvalue()


def write_pk(buf, pk, g1spec, g2spec):
    """Write `pk` in `pk_to_bytes`'s format to `buf`, an open binary file,
    one section at a time: a key of tens of gigabytes goes to disk with
    no more than one base array's bytes held beside it."""
    buf.write(_MAGIC)
    buf.write(b"PK")
    buf.write(pk.domain_log.to_bytes(4, "big"))
    nb1, nb2 = _field_nbytes(g1spec), _field_nbytes(g2spec)
    nc2 = _ncomp(g2spec)
    for pt in (pk.alpha_g1, pk.beta_g1, pk.delta_g1):
        _write_point(buf, pt, nb1, 1)
    for pt in (pk.beta_g2, pk.delta_g2):
        _write_point(buf, pt, nb2, nc2)
    for b in (
        pk.a_g1, pk.b_g1, pk.k_g1, pk.z_g1, pk.b_g2,
        pk.k_commit_g1, pk.k_commit_eta_g1,
    ):
        _write_bases(buf, b)
    _write_idx(buf, pk.a_indices)
    _write_idx(buf, pk.b_indices)
    _write_idx(
        buf,
        None if pk.k_priv_indices is None else list(pk.k_priv_indices),
    )


def pk_from_bytes(data: bytes, g1spec, g2spec):
    return read_pk(io.BytesIO(data), g1spec, g2spec)


def read_pk(buf, g1spec, g2spec):
    """The proving key `write_pk` wrote, read from `buf`, an open binary
    file, one section at a time."""
    from davinci_tpu_torch.groth16.core import ProvingKey

    assert buf.read(len(_MAGIC)) == _MAGIC, "bad artifact magic"
    assert buf.read(2) == b"PK", "not a proving key"
    domain_log = int.from_bytes(buf.read(4), "big")
    nb1, nb2 = _field_nbytes(g1spec), _field_nbytes(g2spec)
    nc2 = _ncomp(g2spec)
    alpha_g1 = _read_point(buf, g1spec, nb1, 1)
    beta_g1 = _read_point(buf, g1spec, nb1, 1)
    delta_g1 = _read_point(buf, g1spec, nb1, 1)
    beta_g2 = _read_point(buf, g2spec, nb2, nc2)
    delta_g2 = _read_point(buf, g2spec, nb2, nc2)
    a_g1 = _read_bases(buf)
    b_g1 = _read_bases(buf)
    k_g1 = _read_bases(buf)
    z_g1 = _read_bases(buf)
    b_g2 = _read_bases(buf)
    k_commit_g1 = _read_bases(buf)
    k_commit_eta_g1 = _read_bases(buf)
    a_indices = _read_idx(buf)
    b_indices = _read_idx(buf)
    k_idx = _read_idx(buf)
    return ProvingKey(
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        a_g1=a_g1,
        b_g1=b_g1,
        b_g2=b_g2,
        k_g1=k_g1,
        z_g1=z_g1,
        domain_log=domain_log,
        a_indices=a_indices,
        b_indices=b_indices,
        k_commit_g1=k_commit_g1,
        k_commit_eta_g1=k_commit_eta_g1,
        k_priv_indices=None if k_idx is None else k_idx.tolist(),
    )


def vk_to_bytes(vk, g1spec, g2spec) -> bytes:
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(b"VK")
    nb1, nb2 = _field_nbytes(g1spec), _field_nbytes(g2spec)
    nc2 = _ncomp(g2spec)
    _write_point(buf, vk.alpha_g1, nb1, 1)
    for pt in (vk.beta_g2, vk.gamma_g2, vk.delta_g2):
        _write_point(buf, pt, nb2, nc2)
    _write_points(buf, vk.k_pub_g1, g1spec)
    # commitment extension
    has = vk.k_challenge_g1 is not None
    buf.write(b"\x01" if has else b"\x00")
    if has:
        _write_point(buf, vk.k_challenge_g1, nb1, 1)
    _write_point(buf, vk.eta_g2, nb2, nc2)
    return buf.getvalue()


def vk_from_bytes(data: bytes, g1spec, g2spec):
    from davinci_tpu_torch.groth16.core import VerifyingKey

    buf = io.BytesIO(data)
    assert buf.read(len(_MAGIC)) == _MAGIC, "bad artifact magic"
    assert buf.read(2) == b"VK", "not a verifying key"
    nb1, nb2 = _field_nbytes(g1spec), _field_nbytes(g2spec)
    nc2 = _ncomp(g2spec)
    alpha_g1 = _read_point(buf, g1spec, nb1, 1)
    beta_g2 = _read_point(buf, g2spec, nb2, nc2)
    gamma_g2 = _read_point(buf, g2spec, nb2, nc2)
    delta_g2 = _read_point(buf, g2spec, nb2, nc2)
    k_pub_g1 = _read_points(buf, g1spec)
    has = buf.read(1) == b"\x01"
    k_challenge_g1 = _read_point(buf, g1spec, nb1, 1) if has else None
    eta_g2 = _read_point(buf, g2spec, nb2, nc2)
    return VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        k_pub_g1=k_pub_g1,
        k_challenge_g1=k_challenge_g1,
        eta_g2=eta_g2,
    )


# -- proofs (small; JSON-friendly dict of hex ints) --------------------------


def _coord_json(v):
    comps = _coord_components(v)
    return [hex(c) for c in comps]


def proof_to_dict(proof) -> dict:
    def pt(p):
        if p.infinity:
            return None
        return {"x": _coord_json(p.x.v), "y": _coord_json(p.y.v)}

    out = {"a": pt(proof.a), "b": pt(proof.b), "c": pt(proof.c)}
    if getattr(proof, "d", None) is not None:
        out["d"] = pt(proof.d)
        out["pok"] = pt(proof.pok)
    return out


def proof_from_dict(d: dict, g1spec, g2spec):
    from davinci_tpu_torch.groth16.core import CommittedProof, Proof

    def pt(obj, spec):
        if obj is None:
            return AffinePoint(spec, None, None)
        xs = [int(h, 16) for h in obj["x"]]
        ys = [int(h, 16) for h in obj["y"]]
        fld = spec.fld
        if len(xs) == 1:
            return AffinePoint(spec, fld(xs[0]), fld(ys[0]))
        return AffinePoint(spec, FF(fld, tuple(xs)), FF(fld, tuple(ys)))

    if "d" in d:
        return CommittedProof(
            a=pt(d["a"], g1spec), b=pt(d["b"], g2spec), c=pt(d["c"], g1spec),
            d=pt(d["d"], g1spec), pok=pt(d["pok"], g1spec),
        )
    return Proof(a=pt(d["a"], g1spec), b=pt(d["b"], g2spec), c=pt(d["c"], g1spec))


# -- constraint-system structure hash ---------------------------------------


def cs_structure_hash(cs) -> str:
    """sha256 of the R1CS structure (matrices + shape), the content-address
    of circuit artifacts (reference circuits/artifacts.go hash pinning)."""
    h = hashlib.sha256()
    h.update(cs.p.to_bytes(96, "big"))
    h.update(cs.num_public.to_bytes(8, "big"))
    h.update(cs.num_variables.to_bytes(8, "big"))
    h.update(len(cs.constraints).to_bytes(8, "big"))
    for idx, coeff, offs in cs._flat_matrices():
        h.update(idx.tobytes())
        h.update(offs.tobytes())
        for c in coeff:
            h.update(int(c).to_bytes(96, "big"))
    return h.hexdigest()


# -- solved constraint system (CCS role) -------------------------------------
#
# gnark caches the compiled constraint system next to PK/VK so a fresh
# process proves without re-running circuit definition code
# (circuits/artifacts.go:74-571).  Here the analogue is the SOLVED system:
# CSR matrices + witness values + commitment/refinalize metadata — enough
# for Groth16.prove / prove_committed_reuse with ZERO Python circuit
# construction.  Coefficients are dictionary-encoded (a circuit has few
# distinct coefficients — powers of two, small ints, p-k values), so the
# big arrays are int32/int64.

_CS_MAGIC = b"DVTCS1\n"


class _Len:
    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


class _LoadedRefinalize:
    """Rebuilt LookupRangeChecker.refinalize: re-solve the challenge-
    dependent wires (gamma, per-value and per-table-entry inverses, table
    products) in place from stored indices."""

    def __init__(self, cs, tb, gamma_idx, inv_idx, prod_idx, m_idx,
                 checked_vals):
        self.cs = cs
        self.tb = tb
        self._gamma_idx = gamma_idx
        self._inv_idx = inv_idx
        self._prod_idx = prod_idx
        self._m_idx = m_idx
        self._checked_vals = checked_vals

    def __call__(self, challenge_value: int):
        cs, p = self.cs, self.cs.p
        n_table = 1 << self.tb
        assert challenge_value == 0 or challenge_value >= n_table
        g = challenge_value % p
        cs.values[self._gamma_idx] = g
        from davinci_tpu_torch.circuits.lookup import batch_inverse

        nv = len(self._checked_vals)
        invs = batch_inverse([(g - v) % p for v in self._checked_vals]
                             + [(g - j) % p for j in range(n_table)], p)
        table_invs = invs[nv:]
        for idx, iv in zip(self._inv_idx[:nv], invs):
            cs.values[idx] = iv
        for j in range(n_table):
            cs.values[self._inv_idx[nv + j]] = table_invs[j]
            cs.values[self._prod_idx[j]] = (
                cs.values[self._m_idx[j]] * table_invs[j] % p
            )


class SolvedSystem:
    """A deserialized solved R1CS: quacks like ConstraintSystem for the
    prove paths (witness, matvec_all, committed wires, refinalize)."""

    def __init__(self, p, num_public, values, mats, committed,
                 challenge_idx, refin_state=None):
        self.p = p
        self.num_public = num_public
        self.values = values
        self._mats = mats
        self.committed = committed
        self.challenge_idx = challenge_idx
        self.constraints = _Len(len(mats[0][2]) - 1)
        if refin_state is not None:
            self._refinalize = _LoadedRefinalize(self, *refin_state)

    @property
    def num_variables(self):
        return len(self.values)

    def witness(self):
        return list(self.values)

    def public_values(self):
        return self.values[1 : 1 + self.num_public]

    def matvec_all(self, z, N: int):
        from davinci_tpu_torch.groth16.r1cs import matvec_flat

        return matvec_flat(self._mats, self.p, len(self.constraints), z, N)

    def _flat_matrices(self):
        return self._mats

    def check_satisfied(self) -> bool:
        from davinci_tpu_torch.groth16.r1cs import check_satisfied_flat

        return check_satisfied_flat(
            self._mats, self.p, len(self.constraints), self.values
        )


def _write_bigints(buf, vals, nbytes: int):
    buf.write(len(vals).to_bytes(8, "big"))
    out = bytearray(len(vals) * nbytes)
    for i, v in enumerate(vals):
        out[i * nbytes : (i + 1) * nbytes] = int(v).to_bytes(nbytes, "big")
    buf.write(bytes(out))


def _read_bigints(buf, nbytes: int) -> list:
    n = int.from_bytes(buf.read(8), "big")
    raw = buf.read(n * nbytes)
    return [
        int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "big")
        for i in range(n)
    ]


def solved_to_bytes(cs) -> bytes:
    """Serialize a solved (optionally committed/lookup) system."""
    buf = io.BytesIO()
    buf.write(_CS_MAGIC)
    nb = (cs.p.bit_length() + 7) // 8
    buf.write(nb.to_bytes(2, "big"))
    buf.write(cs.p.to_bytes(nb, "big"))
    buf.write(int(cs.num_public).to_bytes(8, "big"))
    _write_bigints(buf, cs.values, nb)
    # matrices: dictionary-encoded coefficients
    table: dict = {}
    mats = cs._flat_matrices()
    for idx, coeff, offs in mats:
        ids = np.empty(len(coeff), np.int64)
        for i, c in enumerate(coeff):
            ci = int(c)
            t = table.get(ci)
            if t is None:
                t = table[ci] = len(table)
            ids[i] = t
        _write_arr(buf, idx, np.int64)
        _write_arr(buf, ids, np.int64)
        _write_arr(buf, offs, np.int64)
    _write_bigints(buf, list(table.keys()), nb)
    # commitment metadata
    _write_idx(buf, cs.committed or None)
    ch = cs.challenge_idx
    buf.write((ch if ch is not None else -1).to_bytes(8, "big", signed=True))
    # lookup refinalize state
    refin = getattr(cs, "_refinalize", None)
    chk = getattr(refin, "__self__", None) if refin is not None else None
    if chk is not None and hasattr(chk, "_inv_idx"):
        buf.write(b"\x01")
        buf.write(int(chk.tb).to_bytes(2, "big"))
        buf.write(int(chk._gamma_idx).to_bytes(8, "big"))
        _write_arr(buf, np.asarray(chk._inv_idx, np.int64), np.int64)
        _write_arr(buf, np.asarray(chk._prod_idx, np.int64), np.int64)
        _write_arr(buf, np.asarray(chk._m_idx, np.int64), np.int64)
        _write_bigints(buf, [v.value for v in chk._checked], nb)
    else:
        buf.write(b"\x00")
    return buf.getvalue()


def solved_from_bytes(data: bytes) -> SolvedSystem:
    buf = io.BytesIO(data)
    assert buf.read(len(_CS_MAGIC)) == _CS_MAGIC, "bad solved-system blob"
    nb = int.from_bytes(buf.read(2), "big")
    p = int.from_bytes(buf.read(nb), "big")
    num_public = int.from_bytes(buf.read(8), "big")
    values = _read_bigints(buf, nb)
    raw_mats = []
    for _ in range(3):
        idx = _read_arr(buf, np.int64)
        ids = _read_arr(buf, np.int64)
        offs = _read_arr(buf, np.int64)
        raw_mats.append((idx, ids, offs))
    table = _read_bigints(buf, nb)
    tarr = np.empty(len(table), object)
    tarr[:] = table
    mats = tuple(
        (idx, tarr[ids], offs) for idx, ids, offs in raw_mats
    )
    committed = _read_idx(buf)
    committed = list(committed) if committed is not None else []
    ch = int.from_bytes(buf.read(8), "big", signed=True)
    challenge_idx = None if ch < 0 else ch
    refin_state = None
    if buf.read(1) == b"\x01":
        tb = int.from_bytes(buf.read(2), "big")
        gamma_idx = int.from_bytes(buf.read(8), "big")
        inv_idx = _read_arr(buf, np.int64).tolist()
        prod_idx = _read_arr(buf, np.int64).tolist()
        m_idx = _read_arr(buf, np.int64).tolist()
        checked_vals = _read_bigints(buf, nb)
        refin_state = (tb, gamma_idx, inv_idx, prod_idx, m_idx,
                       checked_vals)
    return SolvedSystem(
        p, num_public, values, mats, committed, challenge_idx, refin_state
    )
