"""Device witness reduction: (A z, B z, C z) mod r from a device-resident
CSR of the constraint matrices and the packed witness.  Counterpart of
`davinci_tpu/groth16/witness_dev.py`.

Scheme per matrix: terms (var, coeff_id, row) with a small dictionary of
distinct coefficients.  For each term the L x L base-2^12 limb
convolution of coeff x z[var] lands in 2L-1 columns (products < 2^24),
index-added per row into an int64 accumulator, then each row's
redundant columns are carry-propagated and folded mod r with two
constant multiplications:

    v = g0 + 2^(12L) g1 + 2^(24L) g2   (Montgomery, on the device).

torch has native int64, so no 64-bit scope is needed; the CSR stays on
the device across proves.  The carries and the fold run `_ROWS` rows at
a time, so that only the accumulator is full height.
"""

from __future__ import annotations

import numpy as np
import torch

from davinci_tpu_torch.fields import LIMB_BITS
from davinci_tpu_torch.ff.mod import normalize

_CHUNK = 1 << 18  # terms per index-add step: bounds transient conv memory
# rows per carry-and-fold step: bounds their int64 temporaries, which at
# a 2^24 domain and full height would be several (N, 2L + 6) tensors of
# 6 GiB each
_ROWS = 1 << 20
_EXTRA = 6  # carry drain limbs: a column stays below 2^55, 55/12 < 5


class DeviceCSR:
    """Device-resident constraint matrices for matvec_device.

    Built once per circuit structure and reusable across proves: the
    structure is witness-independent."""

    def __init__(self, mats, r: int, L: int, device="cuda"):
        self.r = r
        self.L = L
        self.device = torch.device(device)
        self.parts = []
        mask = (1 << LIMB_BITS) - 1
        for idx, coeff, offs in mats:
            T = len(idx)
            rows = np.repeat(
                np.arange(len(offs) - 1, dtype=np.int64),
                np.diff(offs).astype(np.int64),
            )
            table: dict = {0: 0}
            ids = np.empty(T, np.int64)
            for i, c in enumerate(coeff):
                ci = int(c)
                t = table.get(ci)
                if t is None:
                    t = table[ci] = len(table)
                ids[i] = t
            tl = np.zeros((len(table), L), np.int64)
            for c, tid in table.items():
                v = c % r
                for j in range(L):
                    tl[tid, j] = (v >> (LIMB_BITS * j)) & mask
            self.parts.append(tuple(
                torch.as_tensor(a, device=self.device)
                for a in (np.asarray(idx, np.int64), ids, rows, tl)
            ))


def _term_cols(cl, zl):
    """(C, L) x (C, L) limbs below 2^12 -> (C, 2L) int64 product columns
    (the last is 0), shifted and added limb by limb as the reference does:
    integer work, exact, and no float64 on the card."""
    C, L = cl.shape
    out = torch.zeros((C, 2 * L), dtype=torch.int64, device=cl.device)
    for i in range(L):
        out[:, i:i + L] += cl[:, i:i + 1] * zl
    return out


def _accumulate(var_idx, coeff_ids, row_ids, table_limbs, n_rows: int,
                Z_limbs):
    """Index-add the per-term limb convolutions into (n_rows, 2L) int64 row
    accumulators."""
    L = table_limbs.shape[1]
    acc = torch.zeros((n_rows, 2 * L), dtype=torch.int64,
                      device=table_limbs.device)
    for s in range(0, var_idx.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        zl = Z_limbs[var_idx[sl]].to(torch.int64)  # (C, L) < 2^12
        cl = table_limbs[coeff_ids[sl]]  # (C, L) < 2^12
        acc.index_add_(0, row_ids[sl], _term_cols(cl, zl))
    return acc


def _carry_cols(acc):
    """(N, 2L) int64 redundant columns -> (N, 2L+6) int32 base-2^12 limbs."""
    cols = torch.cat([acc, torch.zeros_like(acc[:, :_EXTRA])], dim=1)
    return normalize(cols, LIMB_BITS, 56).to(torch.int32)


def _fold_mont(df, Lb, c1m, c2m):
    """(N, 2L+6) int32 base-2^12 limbs -> (N, L) Montgomery residues."""
    L = df.L
    g0 = Lb[:, :L]
    g1 = Lb[:, L : 2 * L]
    g2 = torch.nn.functional.pad(Lb[:, 2 * L :], (0, 3 * L - Lb.shape[1]))
    # to_mont accepts raw < 2^(12L) (t = raw * r2 < R*r keeps REDC exact)
    v = df.add(df.to_mont(g0), df.mul(df.to_mont(g1), c1m))
    return df.add(v, df.mul(df.to_mont(g2), c2m))


def matvec_device(df, dcsr: DeviceCSR, Z_limbs, N: int):
    """(A z, B z, C z) as (N, L) Montgomery device tensors (rows past the
    constraint count are zero, matching the quotient-domain layout)."""
    r, L = dcsr.r, dcsr.L
    c1m = df.encode_scalar(pow(2, LIMB_BITS * L, r))
    c2m = df.encode_scalar(pow(2, 2 * LIMB_BITS * L, r))
    out = []
    for vi, ci, ri, tl in dcsr.parts:
        acc = _accumulate(vi, ci, ri, tl, N, Z_limbs)
        v = torch.empty((N, L), dtype=torch.int32, device=acc.device)
        for s in range(0, N, _ROWS):
            v[s:s + _ROWS] = _fold_mont(df, _carry_cols(acc[s:s + _ROWS]),
                                        c1m, c2m)
        del acc
        out.append(v)
    return out


def satisfied_device(df, az, bz, cz, n_cons: int):
    """all(az*bz == cz) over the first n_cons rows, on the device."""
    d = df.sub(df.mul(az[:n_cons], bz[:n_cons]), cz[:n_cons])
    return (d == 0).all()
