"""Number-theoretic transform (radix-2) over SNARK scalar fields: the
quotient-polynomial transforms inside Groth16 proving.  Counterpart of
`davinci_tpu/ntt/ntt.py`.

Constant-geometry Stockham DIF: every stage halves, butterflies,
gathers twiddles and permutes with host-precomputed (logn, n) permutation
and (logn, n/2) twiddle-exponent tables; natural order in and out.  Data
is (..., n, L) int32 Montgomery limbs at the boundary and stays in wide
limbs across the stages; every product is `DeviceField.mul` (kernel B6
on CUDA tensors).  `sharded_ntt` runs the same transform over the ranks
of a mesh axis (`parallel/mesh.py`) as Bailey's four steps, each rank
holding one natural-order block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from davinci_tpu_torch.ff.mod import (
    carry_fix,
    from_wide,
    get_device_field,
    to_wide,
)
from davinci_tpu_torch.parallel.mesh import (
    all_to_all_rows,
    axis_rank,
    axis_size,
    reduce_scatter_rows,
)


@functools.lru_cache(maxsize=16)
def _stage_tables_np(n: int):
    """perm (logn, n): output position i of stage s reads butterfly output
    [b*(n/2) + j*m + t] where i = j*2m + b*m + t, m = 2^s;
    exps (logn, n/2): twiddle exponents (j*m for flat lane j*m+t)."""
    logn = n.bit_length() - 1
    perm = np.zeros((max(logn, 1), n), np.int64)
    exps = np.zeros((max(logn, 1), max(n // 2, 1)), np.int64)
    i = np.arange(n)
    half = np.arange(n // 2)
    for s in range(logn):
        m = 1 << s
        j, rem = i // (2 * m), i % (2 * m)
        b, t = rem // m, rem % m
        perm[s] = b * (n // 2) + j * m + t
        exps[s] = (half // m) * m
    return perm, exps


class DeviceNTT:
    def __init__(self, spec, device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self.df = get_device_field(spec, self.device)
        self._tables = {}
        self._powers = {}  # power_table's results by (g, n)

    def _roots(self, logn: int):
        """(omega, omega_inv, n_inv) as host ints for a 2^logn domain."""
        w = self.spec.root_of_unity(logn)
        winv = pow(w, -1, self.spec.p)
        ninv = pow(1 << logn, -1, self.spec.p)
        return w, winv, ninv

    def _stage_tables(self, n: int):
        if n not in self._tables:
            perm, exps = _stage_tables_np(n)
            self._tables[n] = (torch.as_tensor(perm, device=self.device),
                               torch.as_tensor(exps, device=self.device))
        return self._tables[n]

    def power_table(self, g: int, n: int) -> torch.Tensor:
        """[1, g, g^2, ..., g^(n-1)] as (n, L) Montgomery limbs, built on
        the device with log2(n) batched muls once per (g, n) and kept: the
        twiddles and coset scales are constants of the domain, so every
        transform after the first reuses them (callers never write into
        a table).  The reference rebuilds them per transform, with the
        same limbs."""
        key = (g % self.spec.p, n)
        table = self._powers.get(key)
        if table is None:
            df = self.df
            p = torch.stack([df.one_mont, df.encode_scalar(g)])
            cur = g * g % self.spec.p
            while p.shape[0] < n:
                p = torch.cat([p, df.mul(p, df.encode_scalar(cur)[None, :])])
                cur = cur * cur % self.spec.p
            table = self._powers[key] = p[:n]
        return table

    def _butterflies(self, x: torch.Tensor, wpow, n: int) -> torch.Tensor:
        """Constant-geometry Stockham DIF stages: natural order in/out.
        wpow: (n/2, L) powers of omega.  The data stays in wide limbs
        between stages; each stage's product (B6 on CUDA) takes the
        difference in 12-bit limbs and the twiddles as they are."""
        df = self.df
        perm, exps = self._stage_tables(n)
        half = n // 2
        w = to_wide(x)
        for s in range(n.bit_length() - 1):
            u = w[..., :half, :]
            v = w[..., half:, :]
            prod = df.mul(wpow[exps[s]], from_wide(df.sub_w(u, v), df.L))
            z = torch.cat([df.add_w(u, v), to_wide(prod)], dim=-2)
            w = z.index_select(-2, perm[s])
        return from_wide(w, df.L)

    def _wpow(self, w: int, n: int):
        return self.power_table(w, n // 2) if n > 1 else self.df.one_mont[None]

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT: coefficients -> evaluations on the 2^k domain.
        x: (..., n, L) Montgomery limbs."""
        n = x.shape[-2]
        logn = n.bit_length() - 1
        if 1 << logn != n:
            raise ValueError(f"NTT size {n} is not a power of two")
        w, _, _ = self._roots(logn)
        return self._butterflies(x, self._wpow(w, n), n)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT: evaluations -> coefficients."""
        n = x.shape[-2]
        logn = n.bit_length() - 1
        if 1 << logn != n:
            raise ValueError(f"NTT size {n} is not a power of two")
        _, winv, ninv = self._roots(logn)
        x = self._butterflies(x, self._wpow(winv, n), n)
        return self.df.mul(x, self.df.encode_scalar(ninv))

    # -- explicit-root transforms -------------------------------------------

    def ntt_with_root(self, x: torch.Tensor, w: int) -> torch.Tensor:
        n = x.shape[-2]
        if pow(w, n, self.spec.p) != 1:
            raise ValueError("w is not an n-th root of unity")
        return self._butterflies(x, self._wpow(w, n), n)

    def intt_with_root(self, x: torch.Tensor, w: int) -> torch.Tensor:
        n = x.shape[-2]
        winv = pow(w, -1, self.spec.p)
        ninv = pow(n, -1, self.spec.p)
        x = self._butterflies(x, self._wpow(winv, n), n)
        return self.df.mul(x, self.df.encode_scalar(ninv))

    # -- sharded transforms (multi-card) ------------------------------------
    #
    # Bailey four-step NTT over a mesh axis of D ranks, rank b holding rows
    # [b n2, (b+1) n2) of the natural order, n2 = n / D: (1) all_to_all
    # reshards the natural blocks to the strided decomposition (rank b gets
    # x[b + D k]), (2) local length-n2 Stockham transforms with root w^D,
    # (3) the per-rank twiddles w^(b k2), (4) the cross-rank length-D DFT
    # as D scaled copies summed by reduce_scatter, whose output lands in
    # natural blocks.  Each collective moves n elements.

    def _shard_tables(self, n: int, D: int, w: int, b: int):
        """Rank b's tables for a size-n transform over D ranks: the
        twiddles (n2, L) [w^(b k2)] and the cross-DFT weights (D, L)
        [w^(n2 b k1)], Montgomery (the reference's (D, ...) tables at
        row b), from the cached power tables."""
        p = self.spec.p
        n2 = n // D
        return (self.power_table(pow(w, b, p), n2),
                self.power_table(pow(w, n2 * b, p), D))

    def sharded_ntt(self, x: torch.Tensor, mesh, axis_name: str = "shard",
                    inverse: bool = False) -> torch.Tensor:
        """Forward (or inverse) NTT of a length-n vector sharded over the
        mesh axis: x is this rank's natural-order block (n/D, L), and so
        is the result, limb-equal to that block of ntt()/intt()."""
        df = self.df
        L = df.L
        D, b = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
        n2 = x.shape[0]
        n = n2 * D
        assert n2 % D == 0, (n, D)
        logn2 = n2.bit_length() - 1
        if 1 << logn2 != n2:
            raise ValueError(f"NTT block {n2} is not a power of two")
        w, winv, ninv = self._roots(n.bit_length() - 1)
        if inverse:
            w = winv
        tw, small = self._shard_tables(n, D, w, b)
        # (1) natural blocks -> strided decomposition: chunk d of the send
        # buffer, rows x[j D + d], goes to rank d
        g = all_to_all_rows(mesh, x.reshape(n2 // D, D, L).transpose(0, 1),
                            axis_name)
        # (2) local Stockham over the n2 strided rows with root w^D
        wD = pow(w, D, self.spec.p)
        a = self._butterflies(g.reshape(n2, L), self._wpow(wD, n2), n2)
        # (3) per-rank twiddle w^(b k2)
        a = df.mul(a, tw)
        # (4) cross-rank DFT over b: D scaled copies, summed and scattered
        contrib = df.mul(a[None], small[:, None, :])  # (D, n2, L)
        out = reduce_scatter_rows(mesh, contrib.reshape(D * n2, L), axis_name)
        # the sum adds limb columns without reduction (a value below D p,
        # limbs below D 2^12): one carry pass, then the product by 1 or
        # 1/n, the raw operand first (B6 takes a raw value below R there)
        return df.mul(carry_fix(out, L),
                      df.encode_scalar(ninv if inverse else 1))

    def sharded_intt(self, x, mesh, axis_name: str = "shard"):
        return self.sharded_ntt(x, mesh, axis_name, inverse=True)

    # -- coset helpers (quotient polynomial) --------------------------------

    def coset_ntt(self, coeffs: torch.Tensor, g: int | None = None):
        """Evaluate on the coset g*H: scale coeff_i by g^i then NTT."""
        n = coeffs.shape[-2]
        if g is None:
            g = self.spec.multiplicative_generator
        return self.ntt(self.df.mul(coeffs, self.power_table(g, n)))

    def coset_intt(self, evals: torch.Tensor, g: int | None = None):
        """Interpolate from coset evaluations: iNTT then scale by g^-i."""
        n = evals.shape[-2]
        if g is None:
            g = self.spec.multiplicative_generator
        ginv = pow(g, -1, self.spec.p)
        return self.df.mul(self.intt(evals), self.power_table(ginv, n))


@functools.cache
def get_device_ntt(spec, device="cuda") -> DeviceNTT:
    return DeviceNTT(spec, torch.device(device))
