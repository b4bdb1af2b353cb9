"""EIP-4844 blob KZG: commitments, opening proofs, barycentric evaluation.
Counterpart of `davinci_tpu/blobs/kzg.py`.

Role parity: the c-kzg-4844 / go-kzg path behind reference types/blobs.go
(ComputeCommitment, ComputeProof) and crypto/blobs/ (barycentric evaluation,
evaluation-point derivation blob.go:106-124).

Commitments and proofs are 4096-point BLS12-381 G1 MSMs over the
ceremony's Lagrange setup on the card: `msm`'s scan route, kernels B2-B5
and B1 built for L = 32, with the setup's planes packed once per device.
The device comes in as an argument and defaults to the card; CPU tensors
take the plain MSM.  Every other function is host code and keeps the
reference's text.  Self-validation: commitment/proof pairs are checked
against the real ceremony setup through the pairing equation
e(C - [y]G1, G2) == e(W, [tau - z]G2).

Conventions (c-kzg): blob cell i holds p(omega^brp(i)); domain generator is
the canonical 7^((r-1)/4096).
"""

from __future__ import annotations

import functools
import hashlib

import torch

from davinci_tpu_torch import curves as C
from davinci_tpu_torch import fields as F
from davinci_tpu_torch.blobs.setup import _brp, load_trusted_setup
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.hash import multi_poseidon
from davinci_tpu_torch.msm import msm
from davinci_tpu_torch.msm.bucket_kernel import pack_points
from davinci_tpu_torch.msm.pippenger import scalars_to_limbs
from davinci_tpu_torch.pairing import bls381_pairing

BLOB_CELLS = 4096
CELL_BYTES = 32
R = F.BLS12_381_R


class Blob:
    """4096 x 32-byte big-endian field elements (reference types/blobs.go)."""

    def __init__(self, cells: list[int] | None = None):
        cells = list(cells or [])
        assert len(cells) <= BLOB_CELLS
        assert all(0 <= c < R for c in cells)
        self.cells = cells + [0] * (BLOB_CELLS - len(cells))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Blob":
        assert len(data) == BLOB_CELLS * CELL_BYTES
        return cls(
            [
                int.from_bytes(data[i * 32 : (i + 1) * 32], "big")
                for i in range(BLOB_CELLS)
            ]
        )

    def to_bytes(self) -> bytes:
        return b"".join(c.to_bytes(32, "big") for c in self.cells)


@functools.cache
def _domain() -> list[int]:
    """roots_of_unity in bit-reversed order: cell i evaluates at domain[i]."""
    w = pow(7, (R - 1) // BLOB_CELLS, R)
    assert pow(w, BLOB_CELLS, R) == 1 and pow(w, BLOB_CELLS // 2, R) != 1
    roots = []
    cur = 1
    for _ in range(BLOB_CELLS):
        roots.append(cur)
        cur = cur * w % R
    bits = BLOB_CELLS.bit_length() - 1
    return [roots[_brp(i, bits)] for i in range(BLOB_CELLS)]


@functools.cache
def _setup_device_points(device="cuda"):
    """The Lagrange setup on `device`: (curve, affine points, their packed
    planes).  The bases are fixed, so they are encoded and packed once per
    device, as `EncodedBases.device_packed` does for a proving key."""
    g1_brp, _ = load_trusted_setup()
    dc = get_device_curve(C.bls381_g1, device)
    pts = dc.encode_points(g1_brp)
    return dc, pts, pack_points(dc, *pts)


def _g1_msm(scalars: list[int], device="cuda"):
    dc, pts, packed = _setup_device_points(device)
    S = torch.as_tensor(scalars_to_limbs(C.bls381_g1, scalars),
                        device=dc.device)
    out = msm(dc, pts, S, precomp=packed)
    return dc.decode_points(tuple(a[None] for a in out))[0]


def compress_g1(pt) -> bytes:
    """ZCash compression of a BLS12-381 G1 point -> 48 bytes."""
    if pt.infinity:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x = pt.x.v
    y = pt.y.v
    data = bytearray(x.to_bytes(48, "big"))
    data[0] |= 0x80  # compressed
    if y > F.BLS12_381_P - y:
        data[0] |= 0x20  # sign
    return bytes(data)


def blob_to_commitment(blob: Blob, device="cuda") -> bytes:
    """KZG commitment (48-byte compressed) via device MSM over the Lagrange
    setup (reference types/blobs.go ComputeCommitment via c-kzg)."""
    return compress_g1(_g1_msm(blob.cells, device))


def evaluate_barycentric(blob: Blob, z: int) -> int:
    """p(z) = (z^N - 1)/N * sum_i p_i * w_i / (z - w_i), with the exact-cell
    shortcut when z is in the domain (reference crypto/blobs/barycentric.go)."""
    dom = _domain()
    z %= R
    for i, w in enumerate(dom):
        if z == w:
            return blob.cells[i]
    n = BLOB_CELLS
    zn = (pow(z, n, R) - 1) % R
    factor = zn * pow(n, -1, R) % R
    # batch inversion of (z - w_i)
    diffs = [(z - w) % R for w in dom]
    prefix = [1] * (n + 1)
    for i, d in enumerate(diffs):
        prefix[i + 1] = prefix[i] * d % R
    inv_all = pow(prefix[n], -1, R)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = prefix[i] * inv_all % R
        inv_all = inv_all * diffs[i] % R
    acc = 0
    for p_i, w, inv_d in zip(blob.cells, dom, invs):
        acc = (acc + p_i * w % R * inv_d) % R
    return acc * factor % R


def compute_kzg_proof(blob: Blob, z: int, device="cuda"):
    """Opening proof at z: W = [q(tau)]G1 with q in evaluation form.
    Returns (proof_bytes48, y).  Handles z inside/outside the domain
    (c-kzg compute_kzg_proof semantics)."""
    dom = _domain()
    z %= R
    y = evaluate_barycentric(blob, z)
    n = BLOB_CELLS
    q = [0] * n
    in_domain_idx = None
    for i, w in enumerate(dom):
        if w == z:
            in_domain_idx = i
            break
    if in_domain_idx is None:
        for i, w in enumerate(dom):
            q[i] = (blob.cells[i] - y) * pow((w - z) % R, -1, R) % R
    else:
        m = in_domain_idx
        wm = dom[m]
        for i, w in enumerate(dom):
            if i == m:
                continue
            q[i] = (blob.cells[i] - y) * pow((w - z) % R, -1, R) % R
            # the removed term folds into cell m (c-kzg in-domain formula):
            # q_m += (p_i - y) * w_i / (w_m * (w_m - w_i))
            q[m] = (
                q[m]
                + (blob.cells[i] - y)
                * w
                % R
                * pow(wm * ((wm - w) % R) % R, -1, R)
                % R
            ) % R
    return compress_g1(_g1_msm(q, device)), y


def verify_kzg_proof(commitment: bytes, z: int, y: int, proof: bytes) -> bool:
    """Pairing check e(C - [y]G1, G2) == e(W, [tau]G2 - [z]G2)."""
    from davinci_tpu_torch.blobs.setup import decompress_g1

    _, g2 = load_trusted_setup()
    Cpt = decompress_g1(commitment)
    Wpt = decompress_g1(proof)
    g1 = C.bls381_g1
    lhs_p = Cpt.add(g1.gen.mul((-y) % R))
    tau_minus_z = g2[1].add(C.bls381_g2.gen.mul((-z) % R))
    # e(lhs, G2) * e(-W, [tau - z]G2) == 1
    return bls381_pairing.pairing_check(
        [(lhs_p, C.bls381_g2.gen), (Wpt.neg(), tau_minus_z)]
    )


def compute_evaluation_point(process_id: int, root_before: int, commitment: bytes) -> int:
    """z = MultiPoseidon(processID, rootBefore, 3 x 16-byte commitment limbs)
    (reference crypto/blobs/blob.go:106-124)."""
    limbs = split_48b_to_limbs(commitment)
    return multi_poseidon([process_id, root_before, *limbs])


def split_48b_to_limbs(b: bytes) -> list[int]:
    assert len(b) == 48
    return [
        int.from_bytes(b[0:16], "big"),
        int.from_bytes(b[16:32], "big"),
        int.from_bytes(b[32:48], "big"),
    ]


def versioned_hash(commitment: bytes) -> bytes:
    """0x01 || sha256(commitment)[1:] (EIP-4844)."""
    h = hashlib.sha256(commitment).digest()
    return b"\x01" + h[1:]
