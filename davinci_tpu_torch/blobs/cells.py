"""EIP-7594 (PeerDAS) cells and cell proofs: the blob extended 2x by
Reed-Solomon, split into 128 cells of 64 field elements, with one KZG
multi-opening proof per cell.  Counterpart of `davinci_tpu/blobs/cells.py`:
the host functions keep the reference's text; the batched device path,
`compute_cell_proofs_device`, runs on torch.

Role parity: c-kzg-4844 ComputeCellsAndKZGProofs behind the reference's
`Blob.ComputeCommitmentAndCellProofs` (types/blobs.go:90-162) — the
version-1 sidecar the on-chain processor submits requires all 128 proofs
(sequencer/onchain.go:168-173).

Device shape: everything reduces to radix-2 NTTs over BLS12-381 Fr and
4096-point Lagrange MSMs — both existing device primitives.  Quotients by
the coset vanishing binomial X^64 - c are a 64-stride linear recurrence.
Since the ceremony file carries only the Lagrange G1 basis, polynomial
commitments evaluate coefficient forms over the 4096 domain first
(NTT + Lagrange MSM) — same group element, no monomial SRS needed.
"""

from __future__ import annotations

import functools

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.blobs import kzg
from davinci_tpu_torch.blobs.kzg import (
    BLOB_CELLS,
    Blob,
    _domain,
    _g1_msm,
    compress_g1,
)
from davinci_tpu_torch.blobs.setup import _brp, load_trusted_setup
from davinci_tpu_torch.pairing import bls381_pairing

CELLS_PER_BLOB = 128
FIELD_ELEMENTS_PER_CELL = 64
EXT_CELLS = BLOB_CELLS * 2  # 8192
_R = F.BLS12_381_R


@functools.cache
def _domain_ext() -> list[int]:
    """8192 roots of unity in bit-reversed order (EIP-4844 PRIMITIVE_ROOT=7
    convention, matching kzg._domain)."""
    root = pow(7, (_R - 1) // EXT_CELLS, _R)
    roots = []
    cur = 1
    for _ in range(EXT_CELLS):
        roots.append(cur)
        cur = cur * root % _R
    bits = 13
    return [roots[_brp(i, bits)] for i in range(EXT_CELLS)]


def _intt_host(evals: list[int], dom_standard: list[int]) -> list[int]:
    """O(n log n) host radix-2 inverse NTT (standard order)."""
    n = len(evals)
    coeffs = _ntt_host(evals, pow(dom_standard[1], -1, _R))
    ninv = pow(n, -1, _R)
    return [c * ninv % _R for c in coeffs]

def _ntt_host(vals: list[int], w: int) -> list[int]:
    n = len(vals)
    if n == 1:
        return list(vals)
    even = _ntt_host(vals[0::2], w * w % _R)
    odd = _ntt_host(vals[1::2], w * w % _R)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % _R
        out[k] = (even[k] + t) % _R
        out[k + n // 2] = (even[k] - t) % _R
        wk = wk * w % _R
    return out


@functools.cache
def _dom4096_standard() -> list[int]:
    root = pow(7, (_R - 1) // BLOB_CELLS, _R)
    out = []
    cur = 1
    for _ in range(BLOB_CELLS):
        out.append(cur)
        cur = cur * root % _R
    return out


@functools.cache
def _dom8192_standard() -> list[int]:
    root = pow(7, (_R - 1) // EXT_CELLS, _R)
    out = []
    cur = 1
    for _ in range(EXT_CELLS):
        out.append(cur)
        cur = cur * root % _R
    return out


def blob_to_coeffs(blob: Blob) -> list[int]:
    """Blob (brp-ordered evaluations over the 4096 domain) -> monomial
    coefficients."""
    bits = 12
    std = [0] * BLOB_CELLS
    for i in range(BLOB_CELLS):
        std[_brp(i, bits)] = blob.cells[i]
    return _intt_host(std, _dom4096_standard())


def compute_cells(blob: Blob) -> list[list[int]]:
    """The 128 extended-domain cells (each 64 evaluations, brp layout)."""
    coeffs = blob_to_coeffs(blob) + [0] * BLOB_CELLS
    w = _dom8192_standard()[1]
    evals = _ntt_host(coeffs, w)
    bits = 13
    brp_evals = [evals[_brp(i, bits)] for i in range(EXT_CELLS)]
    return [
        brp_evals[i * FIELD_ELEMENTS_PER_CELL : (i + 1) * FIELD_ELEMENTS_PER_CELL]
        for i in range(CELLS_PER_BLOB)
    ]


def _cell_points(cell_id: int) -> list[int]:
    dom = _domain_ext()
    return dom[
        cell_id * FIELD_ELEMENTS_PER_CELL : (cell_id + 1)
        * FIELD_ELEMENTS_PER_CELL
    ]


@functools.cache
def _cell_vanishing_constant(cell_id: int) -> int:
    """The cell's points form a multiplicative coset: x^64 is constant on
    it; Z_i(X) = X^64 - c_i."""
    pts = _cell_points(cell_id)
    c = pow(pts[0], FIELD_ELEMENTS_PER_CELL, _R)
    for p in pts[1:]:
        assert pow(p, FIELD_ELEMENTS_PER_CELL, _R) == c, "not a coset"
    return c


def commit_coeffs(coeffs: list[int]):
    """[p(tau)] G1 for deg < 4096, via the Lagrange basis: evaluate over
    the 4096 domain and MSM with the brp Lagrange SRS."""
    assert len(coeffs) <= BLOB_CELLS
    padded = list(coeffs) + [0] * (BLOB_CELLS - len(coeffs))
    evals = _ntt_host(padded, _dom4096_standard()[1])
    bits = 12
    brp_evals = [evals[_brp(i, bits)] for i in range(BLOB_CELLS)]
    return _g1_msm(brp_evals)


def compute_cell_proof(blob: Blob, cell_id: int, coeffs: list[int] | None = None) -> bytes:
    """KZG multi-opening proof for one cell: pi = [q(tau)] G1 with
    q = (p - I_i) / Z_i;  division by the binomial X^64 - c is the
    64-stride recurrence q[k] = p[k+64] + c*q[k+64]."""
    if coeffs is None:
        coeffs = blob_to_coeffs(blob)
    c = _cell_vanishing_constant(cell_id)
    n = len(coeffs)
    q = [0] * n
    for k in range(n - 1 - FIELD_ELEMENTS_PER_CELL, -1, -1):
        q[k] = (coeffs[k + FIELD_ELEMENTS_PER_CELL] + c * q[k + FIELD_ELEMENTS_PER_CELL]) % _R
    return compress_g1(commit_coeffs(q))


def compute_cells_and_proofs(blob: Blob, cell_ids=None):
    """(cells, proofs) for the requested ids (default: all 128 — the
    sidecar path; tests use a subset)."""
    ids = list(cell_ids) if cell_ids is not None else list(range(CELLS_PER_BLOB))
    coeffs = blob_to_coeffs(blob)
    cells = compute_cells(blob)
    proofs = [compute_cell_proof(blob, i, coeffs) for i in ids]
    return [cells[i] for i in ids], proofs


def compute_cell_proofs_device(blob: Blob, cell_ids=None,
                               device="cuda") -> list[bytes]:
    """All 128 cell proofs in ONE batched device pipeline (role: c-kzg-4844
    ComputeCellsAndKZGProofs, reference types/blobs.go:99-105), on
    `device` (the card by default; CPU tensors take every kernel's plain
    version):

      1. blob -> coefficients: the iNTT on the 4096 PRIMITIVE_ROOT=7
         domain
      2. quotients q_i = (p - I_i) / (X^64 - c_i) for every cell at once:
         the 64-stride division recurrence as 63 steps, each one batched
         field mul (B6) and add over all (cell, residue) lanes
      3. quotient evaluations over the 4096 domain: one batched NTT, then
         the bit-reversal gather and the way out of Montgomery form
      4. [q_i(tau)] G1: one msm_many over the Lagrange setup: the (msm,
         window) pairs of all 128 commitments ride the same bucket
         pipeline (B2-B5, B1)

    The evaluations leave the field as raw base-2^12 limbs, which are
    exactly the MSM's scalar windows: no host round trip between the blob
    and the proof points.  Each step is a timed log event ("cells.intt",
    "cells.quotient", "cells.ntt", "cells.msm_many", "cells.decode"),
    whose end waits for the device.
    """
    import contextlib

    import torch

    from davinci_tpu_torch import log
    from davinci_tpu_torch.ff import get_device_field
    from davinci_tpu_torch.msm import msm_many
    from davinci_tpu_torch.ntt import get_device_ntt

    dev = torch.device(device)  # `device` as given keys the cached tables

    @contextlib.contextmanager
    def stage(name):
        with log.info_time(f"cells.{name}"):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    ids = list(cell_ids) if cell_ids is not None else list(range(CELLS_PER_BLOB))
    df = get_device_field(F.bls12_381_fr, device)
    ntt = get_device_ntt(F.bls12_381_fr, device)
    w4096 = _dom4096_standard()[1]
    CL = FIELD_ELEMENTS_PER_CELL  # 64
    T = BLOB_CELLS // CL  # 64 strides
    M = len(ids)

    # 1) brp blob cells -> standard order -> iNTT -> coefficients
    bits = 12
    with stage("intt"):
        std = [0] * BLOB_CELLS
        for i in range(BLOB_CELLS):
            std[_brp(i, bits)] = blob.cells[i]
        coeffs = ntt.intt_with_root(df.encode(std), w4096)  # (4096, L) mont

    # 2) q[64t+j] = p[64(t+1)+j] + c*q[64(t+1)+j], t = 62 .. 0; q_63 = 0
    with stage("quotient"):
        p_mat = coeffs.reshape(T, CL, df.L)  # (64_t, 64_j, L)
        c_b = df.encode([_cell_vanishing_constant(i) for i in ids])[:, None, :]
        q = torch.zeros((T, M, CL, df.L), dtype=torch.int32, device=dev)
        for t in range(T - 2, -1, -1):
            q[t] = df.add(p_mat[t + 1][None], df.mul(c_b, q[t + 1]))
        q_full = q.transpose(0, 1).reshape(M, BLOB_CELLS, df.L)

    # 3) evaluate on the 4096 domain, reorder to the brp Lagrange basis:
    # SRS index k pairs with the evaluation at domain position brp(k)
    # (matching commit_coeffs' host ordering); raw residue limbs are the
    # base-2^12 MSM windows (L == W == 22)
    with stage("ntt"):
        evals = ntt.ntt_with_root(q_full, w4096)  # (M, 4096, L) mont
        brp_perm = torch.as_tensor([_brp(i, bits) for i in range(BLOB_CELLS)],
                                   device=dev)
        scalars = df.from_mont(evals.index_select(-2, brp_perm))

    # 4) one msm_many over the Lagrange setup's packed planes
    with stage("msm_many"):
        dc, pts, packed = kzg._setup_device_points(device)
        out = msm_many(dc, pts, scalars, precomp=packed)
    with stage("decode"):
        return [compress_g1(pt) for pt in dc.decode_points(out)]


def _interp_coset(points: list[int], values: list[int]) -> list[int]:
    """Lagrange interpolation (64 points) -> coefficients (host)."""
    n = len(points)
    # Newton form would be fine; direct Lagrange accumulation:
    coeffs = [0] * n
    for j in range(n):
        # basis_j(X) = prod_{m != j} (X - x_m) / (x_j - x_m)
        num = [1]
        denom = 1
        for m in range(n):
            if m == j:
                continue
            num = _poly_mul_lin(num, points[m])
            denom = denom * (points[j] - points[m]) % _R
        scale = values[j] * pow(denom, -1, _R) % _R
        for k, cco in enumerate(num):
            coeffs[k] = (coeffs[k] + cco * scale) % _R
    return coeffs


def _poly_mul_lin(poly: list[int], root: int) -> list[int]:
    """poly * (X - root)."""
    out = [0] * (len(poly) + 1)
    for i, c in enumerate(poly):
        out[i] = (out[i] - c * root) % _R
        out[i + 1] = (out[i + 1] + c) % _R
    return out


def verify_cell_proof(
    commitment: bytes, cell_id: int, cell: list[int], proof: bytes
) -> bool:
    """e(C - [I_i], H) == e(pi, [Z_i(tau)]_2)."""
    from davinci_tpu_torch.blobs.setup import decompress_g1

    _, g2 = load_trusted_setup()
    C = decompress_g1(commitment)
    pi = decompress_g1(proof)
    c = _cell_vanishing_constant(cell_id)
    pts = _cell_points(cell_id)
    I_coeffs = _interp_coset(pts, cell)
    I_C = commit_coeffs(I_coeffs)
    # Z_2 = [tau^64 - c]_2
    z2 = g2[FIELD_ELEMENTS_PER_CELL].add(g2[0].mul(c).neg())
    lhs = C.add(I_C.neg())
    return bls381_pairing.pairing_check([(lhs, g2[0]), (pi.neg(), z2)])
