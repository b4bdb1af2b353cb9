"""Groth16 setup / prove / verify on one device or, after `set_mesh`,
over the ranks of a mesh axis.  Counterpart of
`davinci_tpu/groth16/core.py`, with its commitment extension: committed
wires live on the gamma basis, exposed through a commitment D in the
proof with a proof of knowledge, and a Fiat-Shamir challenge wire bound
to H(D) (the enabler for the lookup range checks of `circuits/lookup.py`).

Proving runs on the device: the witness reduction, the quotient
polynomial by coset NTTs (the coset vanishing polynomial is constant on
the coset, so the division is one scalar multiply), and the witness-vector
MSMs over the proving key.  Setup evaluates the QAP on the host and makes
the key's bases on the device with fixed-base window tables (the route the
reference takes on its accelerator); on a CPU device it takes the
reference's CPU route, a batched double-and-add.  Verification is a host
pairing check.  The commitment D and its proof of knowledge are two
more G1 MSMs over the key's commitment bases.

With a mesh set (`set_mesh`, a `parallel.get_mesh` mesh), every rank
calls `prove` on the same key and witness: the quotient's transforms run
as the four-step `sharded_ntt` on each rank's block and h is all-gathered
after them, and every proving-key MSM runs as `sharded_msm`.  The proof
is the single-device one on every rank.
"""

from __future__ import annotations

import functools
import random as _random
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from davinci_tpu_torch import fields as F
from davinci_tpu_torch import log
from davinci_tpu_torch.curves import AffinePoint
from davinci_tpu_torch.ec import get_device_curve
from davinci_tpu_torch.ethereum import keccak256
from davinci_tpu_torch.groth16.bases import EncodedBases
from davinci_tpu_torch.groth16.witness_dev import (
    DeviceCSR,
    matvec_device,
    satisfied_device,
)
from davinci_tpu_torch.hash.poseidon import poseidon_hash
from davinci_tpu_torch.msm import msm, pippenger
from davinci_tpu_torch.msm.pippenger import (
    NBUCKETS,
    WINDOW_BITS,
    pack_scalars,
    scalars_to_limbs,
    unpack_limbs,
)
from davinci_tpu_torch.ntt import get_device_ntt
from davinci_tpu_torch.pairing import PAIRINGS
from davinci_tpu_torch.parallel.mesh import (
    all_gather_rows,
    axis_size,
    broadcast_objects,
    shard_batch,
)


@dataclass(eq=False)
class ProvingKey:
    """MSM base sets as EncodedBases.  Zero polynomials are pruned: a/b
    bases cover only wires with u_i != 0 / v_i != 0 (their witness scalars
    are gathered via a_indices/b_indices at prove time)."""

    alpha_g1: AffinePoint
    beta_g1: AffinePoint
    beta_g2: AffinePoint
    delta_g1: AffinePoint
    delta_g2: AffinePoint
    a_g1: EncodedBases       # [u_i(tau)] G1, i in a_indices
    b_g1: EncodedBases       # [v_i(tau)] G1, i in b_indices
    b_g2: EncodedBases       # [v_i(tau)] G2, i in b_indices
    k_g1: EncodedBases       # [(beta u + alpha v + w)/delta] G1, k_priv_indices
    z_g1: EncodedBases       # [tau^j Z(tau)/delta] G1, j < N-1
    domain_log: int
    a_indices: object = None  # np.int64 witness indices for a_g1 (None = all)
    b_indices: object = None
    k_commit_g1: EncodedBases = None
    k_commit_eta_g1: EncodedBases = None
    k_priv_indices: list = None  # witness indices matching k_g1


@dataclass(eq=False)
class VerifyingKey:
    alpha_g1: AffinePoint
    beta_g2: AffinePoint
    gamma_g2: AffinePoint
    delta_g2: AffinePoint
    k_pub_g1: list      # [(beta u + alpha v + w)/gamma] G1, ONE + publics
    k_challenge_g1: AffinePoint = None
    eta_g2: AffinePoint = None


@dataclass(eq=False)
class Proof:
    a: AffinePoint
    b: AffinePoint  # G2
    c: AffinePoint


@dataclass(eq=False)
class CommittedProof(Proof):
    d: AffinePoint = None    # Pedersen commitment to the committed wires
    pok: AffinePoint = None  # knowledge proof: pok == eta * d


def _fixed_base_table_scan(dc, bx, by, bz):
    """(W, ...) per-window bases -> (W, NBUCKETS, ...) window tables via a
    log-depth Hillis-Steele prefix scan (12 batched adds, all windows at
    once)."""
    W = bx.shape[0]
    lane = torch.arange(NBUCKETS, device=bx.device).expand(W, NBUCKETS)
    bw = tuple(
        a[:, None].expand((W, NBUCKETS) + a.shape[1:]) for a in (bx, by, bz)
    )
    ident = dc.identity((W, NBUCKETS))
    cur = dc.select(lane >= 1, bw, ident)
    stride = 1
    while stride < NBUCKETS:
        shifted = tuple(torch.roll(a, stride, dims=1) for a in cur)
        shifted = dc.select(lane >= stride, shifted, ident)
        cur = dc.add(cur, shifted)
        stride <<= 1
    return cur


def _fixed_base_table(dc, gspec):
    """Fixed-base window table T[w, d] = d * 2^(12w) * G for every
    base-2^12 scalar window w and digit d, as (W, 4096, ...) coordinate
    tensors.  The host makes the W row bases; the device builds all rows
    in one scan."""
    W = -(-gspec.r.bit_length() // WINDOW_BITS)
    bases = []
    base_pt = gspec.gen
    for _ in range(W):
        bases.append(base_pt)
        base_pt = base_pt.mul(1 << WINDOW_BITS)
    return _fixed_base_table_scan(dc, *dc.encode_points(bases))


def _fixed_base_mul(dc, tx, ty, tz, S):
    """[s_i * G] from the window table: S (n, W) base-2^12 digits ->
    projective (n, ...) batch.  W gathers + a log-tree of adds."""
    n, W = S.shape
    NB = tx.shape[1]
    tail = tx.shape[2:]
    idx = (torch.arange(W, device=S.device)[:, None] * NB
           + S.T.to(torch.int64)).reshape(-1)
    parts = tuple(
        t.reshape((W * NB,) + tail)[idx].reshape((W, n) + tail)
        for t in (tx, ty, tz)
    )
    # pad the window axis to a power of two with identities, then halve
    Wp = 1 << (W - 1).bit_length() if W > 1 else 1
    if Wp != W:
        ident = dc.identity((Wp - W, n))
        parts = tuple(torch.cat([p, i]) for p, i in zip(parts, ident))
    while Wp > 1:
        half = Wp // 2
        parts = dc.add(tuple(p[:half] for p in parts),
                       tuple(p[half:] for p in parts))
        Wp = half
    return tuple(p[0] for p in parts)


@functools.cache
def _copy_stream(device):
    """The side stream of `_segment_uploads` on a CUDA device: one for
    the process, so that the caching allocator reuses its segments'
    blocks."""
    return torch.cuda.Stream(device)


def _segment_uploads(bases: EncodedBases, spans, device):
    """Yield (X, Y, Z) of `bases[ofs:hi]` on `device` for each (ofs, hi)
    of `spans`, each copied from the host arrays when it is needed and
    never cached.  A helper thread copies the next span while the caller
    computes on the current one (on CUDA on a side stream, which the
    caller's stream then waits for), so at most two spans are on the
    device at once."""
    side = _copy_stream(device) if device.type == "cuda" else None

    def upload(span):
        ofs, hi = span
        if side is None:
            return tuple(torch.from_numpy(a[ofs:hi]).to(device)
                         for a in (bases.x, bases.y, bases.z)), None
        with torch.cuda.stream(side):
            arrs = tuple(torch.from_numpy(a[ofs:hi]).to(device,
                                                        non_blocking=True)
                         for a in (bases.x, bases.y, bases.z))
            return arrs, side.record_event()

    with ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(upload, spans[0]) if spans else None
        for i in range(len(spans)):
            arrs, copied = nxt.result()
            if i + 1 < len(spans):
                nxt = pool.submit(upload, spans[i + 1])
            if side is not None:
                main = torch.cuda.current_stream(device)
                main.wait_event(copied)
                for a in arrs:  # freed only once the caller's work is done
                    a.record_stream(main)
            yield arrs


class ProveError(ValueError, AssertionError):
    """A prove refused: an unsatisfied witness, a quotient that overflows
    its degree, or bases and scalars of different counts.  The reference
    asserts there; callers that catch either type catch this."""


class Groth16:
    """Groth16 over one pairing curve on one device."""

    def __init__(self, curve_name: str, ctx=None, fr=None, device="cuda"):
        """Either a registered curve name, or an explicit (ctx, fr) pair
        (synthetic curve families reuse the whole backend), as in the
        reference."""
        self.curve_name = curve_name
        self.device = torch.device(device)
        self.ctx = ctx or PAIRINGS[curve_name]
        self.fr = fr or {
            "bn254": F.bn254_fr,
            "bls12_377": F.bls12_377_fr,
            "bls12_381": F.bls12_381_fr,
            "bw6_761": F.bw6_761_fr,
        }[curve_name]
        self.g1 = self.ctx.g1
        self.g2 = self.ctx.g2
        self.dc = get_device_curve(self.g1, self.device)
        self.dc2 = get_device_curve(self.g2, self.device)
        self.ntt = get_device_ntt(self.fr, self.device)
        self.r = self.fr.p
        self._tables = {}
        # multi-card proving: with a mesh set, proving-key MSMs run as
        # sharded_msm and the quotient's transforms as the four-step
        # collective transform
        self.mesh = None
        self.mesh_axis = "shard"

    def set_mesh(self, mesh, axis_name: str = "shard"):
        """Distribute proving over a mesh axis (a `torch.distributed`
        DeviceMesh; None for one device).  Every rank proves the same
        witness; the proofs equal the single-device ones."""
        self.mesh = mesh
        self.mesh_axis = axis_name

    # ------------------------------------------------------------------ setup

    def setup(self, cs, rng=None):
        """Trusted setup for the given ConstraintSystem (structure only)."""
        rng = rng or _random.Random(0x5E7)
        r = self.r
        n_cons = len(cs.constraints)
        m = cs.num_variables
        logN = max(1, (n_cons - 1).bit_length()) if n_cons > 1 else 1
        N = 1 << logN

        tau = rng.randrange(1, r)
        alpha = rng.randrange(1, r)
        beta = rng.randrange(1, r)
        gamma = rng.randrange(1, r)
        delta = rng.randrange(1, r)

        # Lagrange values L_j(tau) = Z(tau) * w^j / (N * (tau - w^j));
        # inverses via one batched Montgomery trick
        w = self.fr.root_of_unity(logN)
        z_tau = (pow(tau, N, r) - 1) % r
        ninv = pow(N, -1, r)
        wjs = [1] * N
        for j in range(1, N):
            wjs[j] = wjs[j - 1] * w % r
        dens = [(tau - wj) % r for wj in wjs]
        prefix = [1] * (N + 1)
        for j in range(N):
            prefix[j + 1] = prefix[j] * dens[j] % r
        inv_all = pow(prefix[N], -1, r)
        inv_dens = [0] * N
        for j in reversed(range(N)):
            inv_dens[j] = inv_all * prefix[j] % r
            inv_all = inv_all * dens[j] % r
        lag = [z_tau * wjs[j] % r * inv_dens[j] % r * ninv % r for j in range(N)]

        # u_i(tau), v_i(tau), w_i(tau): sparse accumulation over the CSR
        lag_arr = np.empty(N, object)
        lag_arr[:] = lag
        uvw = []
        for idx, coeff, offs in cs._flat_matrices():
            acc = np.zeros(m, object)
            if len(idx):
                rows = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
                np.add.at(acc, idx, coeff * lag_arr[rows])
            uvw.append([int(x) % r for x in acc])
        u, v, wv = uvw

        ginv = pow(gamma, -1, r)
        dinv = pow(delta, -1, r)
        npub = 1 + cs.num_public
        k_pub = [
            (beta * u[i] + alpha * v[i] + wv[i]) % r * ginv % r
            for i in range(npub)
        ]
        committed = list(getattr(cs, "committed", []) or [])
        chal_idx = getattr(cs, "challenge_idx", None)
        gamma_side = set(committed) | ({chal_idx} if chal_idx is not None else set())
        k_priv_pairs = [
            (i, kv)
            for i in range(npub, m)
            if i not in gamma_side
            and (kv := (beta * u[i] + alpha * v[i] + wv[i]) % r * dinv % r)
        ]
        k_priv_indices = [i for i, _ in k_priv_pairs]
        k_priv = [kv for _, kv in k_priv_pairs]
        eta = rng.randrange(1, r)
        k_commit = [
            (beta * u[i] + alpha * v[i] + wv[i]) % r * ginv % r
            for i in committed
        ]
        k_chal = (
            (beta * u[chal_idx] + alpha * v[chal_idx] + wv[chal_idx])
            % r * ginv % r
            if chal_idx is not None
            else None
        )
        # [tau^j * Z(tau)/delta], j in 0..N-2
        zd = z_tau * dinv % r
        z_scalars = []
        t_acc = zd
        for j in range(N - 1):
            z_scalars.append(t_acc)
            t_acc = t_acc * tau % r

        # prune zero polynomials: wires absent from A (resp. B) contribute
        # nothing to the A/B MSMs
        a_indices = [i for i in range(m) if u[i]]
        b_indices = [i for i in range(m) if v[i]]
        v_nz = [v[i] for i in b_indices]
        # every G1 set in one batch: one double-and-add on the CPU, full
        # chunks of the fixed-base table on the card
        a_g1, b_g1, k_g1, z_g1, kc_g1, kce_g1, kp_g1 = self._batch_mul_sets(
            self.dc, self.g1,
            [[u[i] for i in a_indices], v_nz, k_priv, z_scalars, k_commit,
             [x * eta % r for x in k_commit], k_pub])
        pk = ProvingKey(
            alpha_g1=self.g1.gen.mul(alpha),
            beta_g1=self.g1.gen.mul(beta),
            beta_g2=self.g2.gen.mul(beta),
            delta_g1=self.g1.gen.mul(delta),
            delta_g2=self.g2.gen.mul(delta),
            a_g1=a_g1,
            b_g1=b_g1,
            b_g2=self._batch_mul_enc(self.dc2, self.g2, v_nz),
            k_g1=k_g1,
            z_g1=z_g1,
            domain_log=logN,
            a_indices=np.asarray(a_indices, np.int64),
            b_indices=np.asarray(b_indices, np.int64),
            k_commit_g1=kc_g1,
            k_commit_eta_g1=kce_g1,
            k_priv_indices=k_priv_indices,
        )
        vk = VerifyingKey(
            alpha_g1=pk.alpha_g1,
            beta_g2=pk.beta_g2,
            gamma_g2=self.g2.gen.mul(gamma),
            delta_g2=pk.delta_g2,
            k_pub_g1=kp_g1.to_host_points(self.dc),
            k_challenge_g1=(
                self.g1.gen.mul(k_chal) if k_chal is not None else None
            ),
            eta_g2=self.g2.gen.mul(eta),
        )
        return pk, vk

    # bounds on the device working set of one batch-mul chunk
    _BATCH_MUL_CHUNK = 65536
    _BATCH_MUL_CHUNK_G2 = 16384

    def _batch_mul_sets(self, dc, gspec, sets) -> list:
        """`_batch_mul_enc` of several scalar lists in one call, split back
        into one EncodedBases per list."""
        enc = self._batch_mul_enc(dc, gspec, [s for part in sets for s in part])
        out, ofs = [], 0
        for part in sets:
            out.append(EncodedBases(enc.x[ofs : ofs + len(part)],
                                    enc.y[ofs : ofs + len(part)],
                                    enc.z[ofs : ofs + len(part)]))
            ofs += len(part)
        return out

    def _batch_mul_enc(self, dc, gspec, scalars) -> EncodedBases:
        """[s * gen] for a scalar list as EncodedBases: on an accelerator,
        per-window gathers from a fixed-base table and a log-tree of adds;
        on the CPU, a batched double-and-add.  Affine normalisation runs
        batched on the device either way."""
        if not scalars:
            return EncodedBases.empty(dc)
        n = len(scalars)
        max_chunk = (
            self._BATCH_MUL_CHUNK_G2
            if dc.ops.coord_ndim == 2
            else self._BATCH_MUL_CHUNK
        )
        chunk = min(max_chunk, 1 << (n - 1).bit_length() if n > 1 else 1)
        fixed_base = dc.device.type != "cpu"
        if fixed_base:
            if dc not in self._tables:
                self._tables[dc] = _fixed_base_table(dc, gspec)
            table = self._tables[dc]
        else:
            base = dc.encode_points([gspec.gen] * chunk)
        outs = []
        for ofs in range(0, n, chunk):
            part = list(scalars[ofs : ofs + chunk])
            part += [0] * (chunk - len(part))
            S = torch.as_tensor(scalars_to_limbs(gspec, part), device=dc.device)
            if fixed_base:
                res = dc.affine_encoding(_fixed_base_mul(dc, *table, S))
            else:
                res = dc.affine_encoding(dc.scalar_mul(base, S))
            outs.append(tuple(a.cpu().numpy() for a in res))
        return EncodedBases(
            np.concatenate([o[0] for o in outs])[:n],
            np.concatenate([o[1] for o in outs])[:n],
            np.concatenate([o[2] for o in outs])[:n],
        )

    # ------------------------------------------------------------------ prove

    def prove(self, pk: ProvingKey, cs, r_rand=None, s_rand=None) -> Proof:
        """Prove a *solved* ConstraintSystem (witness inside)."""
        r = self.r
        rng = _random.Random()
        rr = rng.randrange(r) if r_rand is None else r_rand
        ss = rng.randrange(r) if s_rand is None else s_rand
        if self.mesh is not None:  # every rank blinds alike: one proof
            rr, ss = broadcast_objects(self.mesh, [rr, ss], self.mesh_axis)

        z = cs.witness()
        N = 1 << pk.domain_log
        n_cons = len(cs.constraints)
        df = self.ntt.df
        W = -(-self.g1.r.bit_length() // WINDOW_BITS)

        # --- witness reduction on the device --------------------------------
        with log.info_time("groth16.witness_reduce_dev", n_constraints=n_cons):
            dcsr = getattr(cs, "_torch_csr", None)
            if dcsr is None or dcsr.device != self.device:
                dcsr = DeviceCSR(cs._flat_matrices(), r, df.L, self.device)
                cs._torch_csr = dcsr
            # the witness goes up ONCE as packed 32-bit words; every MSM's
            # scalar set is a device gather + a device unpack
            Zp = torch.as_tensor(
                pack_scalars(self.g1, z).view(np.int32), device=self.device
            )
            abc = matvec_device(df, dcsr, unpack_limbs(Zp, W), N)
            if not bool(satisfied_device(df, *abc, n_cons)):
                raise ProveError("witness does not satisfy constraints")

        # --- quotient polynomial h ------------------------------------------
        with log.info_time("groth16.quotient_ntt", domain=N):
            g = self.fr.multiplicative_generator
            coset_fwd, inv, coset_inv, gather = self._quotient_transforms(N)
            # per-polynomial transforms: peak memory ~2 (N, L) tensors
            cosets = [coset_fwd(inv(v)) for v in abc]
            del abc
            num = df.sub(df.mul(cosets[0], cosets[1]), cosets[2])
            del cosets
            zc_inv = pow((pow(g, N, r) - 1) % r, -1, r)
            h_coeffs = coset_inv(df.mul(num, df.encode_scalar(zc_inv)))
            del num
            # raw base-2^12 limbs ARE the MSM scalar format
            h_raw = gather(df.from_mont(h_coeffs))
            del h_coeffs
            if bool((h_raw[N - 1] != 0).any()):
                raise ProveError("quotient degree overflow")

        # --- MSMs -----------------------------------------------------------
        with log.info_time("groth16.msms", n_vars=len(z)):
            npub = 1 + cs.num_public
            h_lin = self._msm_enc(self.dc, self.g1, pk.z_g1, h_raw[: N - 1])
            del h_raw
            ai, bi, ki = self._pk_dev_indices(pk, npub, len(z))
            a_S = unpack_limbs(Zp if ai is None else Zp[ai], W)
            a_lin = self._msm_enc(self.dc, self.g1, pk.a_g1, a_S)
            del a_S
            k_lin = self._msm_enc(self.dc, self.g1, pk.k_g1,
                                  unpack_limbs(Zp[ki], W))
            b_S = unpack_limbs(Zp if bi is None else Zp[bi], W)
            del Zp
            b1_lin = self._msm_enc(self.dc, self.g1, pk.b_g1, b_S)
            b2_lin = self._msm_enc(self.dc2, self.g2, pk.b_g2, b_S)
            del b_S

        # --- assembly (host, tiny) ------------------------------------------
        A = pk.alpha_g1.add(a_lin).add(pk.delta_g1.mul(rr))
        B1 = pk.beta_g1.add(b1_lin).add(pk.delta_g1.mul(ss))
        B2 = pk.beta_g2.add(b2_lin).add(pk.delta_g2.mul(ss))
        Cpt = (
            k_lin.add(h_lin)
            .add(A.mul(ss))
            .add(B1.mul(rr))
            .add(pk.delta_g1.mul((-rr * ss) % r))
        )
        return Proof(a=A, b=B2, c=Cpt)

    def _quotient_transforms(self, N: int):
        """(coset_fwd, inv, coset_inv, gather) for the quotient at domain
        N.  With a mesh of D ranks and D^2 dividing N (the four-step
        decomposition's need), the transforms are the sharded ones: each
        takes and gives this rank's block, `inv` cuts a full vector to it
        first, and `gather` makes h whole again on every rank.  Otherwise
        the single-device transforms, and `gather` is the identity."""
        ntt, mesh, axis = self.ntt, self.mesh, self.mesh_axis
        if mesh is None or N % axis_size(mesh, axis) ** 2:
            return ntt.coset_ntt, ntt.intt, ntt.coset_intt, lambda h: h
        df = ntt.df
        g = self.fr.multiplicative_generator
        gp = shard_batch(mesh, ntt.power_table(g, N), axis)
        gpi = shard_batch(mesh, ntt.power_table(pow(g, -1, self.r), N), axis)
        return (
            lambda c: ntt.sharded_ntt(df.mul(c, gp), mesh, axis),
            lambda e: ntt.sharded_intt(shard_batch(mesh, e, axis), mesh, axis),
            lambda e: df.mul(ntt.sharded_intt(e, mesh, axis), gpi),
            lambda h: all_gather_rows(mesh, h, axis),
        )

    def prove_committed(self, pk: ProvingKey, build_fn, rng=None,
                        r_rand=None, s_rand=None) -> CommittedProof:
        """Prove a circuit that uses cs.commit().

        build_fn(challenge, blind) -> solved ConstraintSystem.  Build with a
        fresh blind and challenge 0 to learn the committed wires, commit
        to them (D and pok), then re-solve with challenge H(D): in place
        through the system's `_refinalize` hook where it has one, else by
        a second build.  Both builds share the key: the structure does
        not depend on the witness."""
        rng = rng or _random.Random()
        blind = rng.randrange(self.r)
        if self.mesh is not None:  # every rank commits to one blind
            [blind] = broadcast_objects(self.mesh, [blind], self.mesh_axis)
        cs0 = build_fn(0, blind)
        committed_vals = [cs0.values[i] for i in cs0.committed]
        D, pok = self._commit(pk, committed_vals)
        challenge = self.commitment_challenge(D)
        refinalize = getattr(cs0, "_refinalize", None)
        if refinalize is not None:
            with log.info_time("groth16.refinalize"):
                refinalize(challenge)
            cs = cs0
        else:
            cs = build_fn(challenge, blind)
        if [cs.values[i] for i in cs.committed] != committed_vals:
            raise ProveError("committed wires must not depend on the challenge")
        base = self.prove(pk, cs, r_rand=r_rand, s_rand=s_rand)
        return CommittedProof(a=base.a, b=base.b, c=base.c, d=D, pok=pok)

    def prove_committed_reuse(self, pk: ProvingKey, cs, rng=None,
                              r_rand=None, s_rand=None) -> CommittedProof:
        """Re-prove an already built committed system with no circuit
        construction: a fresh blind wire, then the challenge-dependent
        wires re-solved in place by the system's `_refinalize` hook.
        Writes `cs.values`."""
        refinalize = getattr(cs, "_refinalize", None)
        if refinalize is None:
            raise ProveError(
                "prove_committed_reuse needs a circuit with a _refinalize hook")
        rng = rng or _random.Random()
        blind = rng.randrange(self.r)
        if self.mesh is not None:  # every rank commits to one blind
            [blind] = broadcast_objects(self.mesh, [blind], self.mesh_axis)
        cs.values[cs.committed[-1]] = blind  # blind wire
        D, pok = self._commit(pk, [cs.values[i] for i in cs.committed])
        challenge = self.commitment_challenge(D)
        with log.info_time("groth16.refinalize"):
            refinalize(challenge)
        base = self.prove(pk, cs, r_rand=r_rand, s_rand=s_rand)
        return CommittedProof(a=base.a, b=base.b, c=base.c, d=D, pok=pok)

    def _commit(self, pk: ProvingKey, committed_vals):
        """(D, pok): the committed wires' MSMs over the commitment basis
        and its eta multiple."""
        with log.info_time("groth16.commit", n_committed=len(committed_vals)):
            D = self._msm_enc(self.dc, self.g1, pk.k_commit_g1, committed_vals)
            pok = self._msm_enc(self.dc, self.g1, pk.k_commit_eta_g1,
                                committed_vals)
        return D, pok

    def commitment_challenge(self, D: AffinePoint) -> int:
        """H(D) mod r, the Fiat-Shamir challenge the verifier recomputes:
        keccak on BN254 (proofs verified by EVM contracts), Poseidon over
        the G1 base field on every other curve (proofs verified inside
        the next circuit of the recursion chain, whose native field that
        is)."""
        if self.curve_name == "bn254":
            nb = (self.g1.fld.p.bit_length() + 7) // 8
            if D.infinity:
                data = b"\x00" * (2 * nb)
            else:
                data = D.x.v.to_bytes(nb, "big") + D.y.v.to_bytes(nb, "big")
            return (
                int.from_bytes(keccak256(b"davinci-commit-v1" + data), "big")
                % self.r
            )
        x, y = (0, 0) if D.infinity else (D.x.v, D.y.v)
        return poseidon_hash([x, y], p=self.g1.fld.p) % self.r

    def _pk_dev_indices(self, pk, npub: int, m: int):
        """Device index tensors for the a/b/k witness gathers, cached on
        the ProvingKey per device."""
        cached = getattr(pk, "_torch_idx", None)
        if cached is not None and cached[0] == self.device:
            return cached[1]

        def dev(ix):
            if ix is None:
                return None
            return torch.as_tensor(np.asarray(ix, np.int64), device=self.device)

        ki = (
            dev(pk.k_priv_indices) if pk.k_priv_indices is not None
            else torch.arange(npub, m, device=self.device)
        )
        idx = (dev(pk.a_indices), dev(pk.b_indices), ki)
        pk._torch_idx = (self.device, idx)
        return idx

    # G1 (G2) sets above these run segment by segment, streamed from the
    # host (`_msm_enc_segmented`); smaller ones stay on the device
    MSM_SEGMENT = 1 << 18
    MSM_SEGMENT_G2 = 1 << 16

    def _msm_enc(self, dc, gspec, bases: EncodedBases, scalars):
        """MSM over pre-encoded bases at the set's natural shape: a set of
        at most one segment is uploaded once and kept on the device with
        its plane pack, a larger one (and every set on a mesh) streamed
        (`_msm_enc_segmented`).

        `scalars` is either a list of host ints or an (n, W) raw base-2^12
        limb array (numpy or a tensor, e.g. the quotient straight off the
        NTT)."""
        n = len(bases)
        if getattr(scalars, "ndim", None) == 2:
            S_full = torch.as_tensor(scalars, device=dc.device)
        else:
            S_full = torch.as_tensor(scalars_to_limbs(gspec, scalars),
                                     device=dc.device)
        if n != S_full.shape[0]:
            raise ProveError(f"{n} bases but {S_full.shape[0]} scalars")
        if n == 0 or not bool(S_full.any()):
            return gspec.infinity()
        seg = self.MSM_SEGMENT_G2 if dc.ops.coord_ndim == 2 else self.MSM_SEGMENT
        if self.mesh is not None or n > seg:
            return self._msm_enc_segmented(dc, gspec, bases, S_full, seg)
        # fixed bases: the scan path's plane pack is made once per key
        precomp = (
            bases.device_packed(dc.device, dc)
            if pippenger._use_pipeline(dc.device)
            and pippenger._use_scan_path(dc)
            else None
        )
        out = msm(dc, bases.device(dc.device), S_full, precomp=precomp)
        return dc.decode_points(tuple(a[None] for a in out))[0]

    def _msm_enc_segmented(self, dc, gspec, bases, S_full, seg):
        """A set above `seg` points, as the reference runs it: segment by
        segment, each taken from the host arrays and freed after its MSM,
        so that no such set is ever whole on the device (at a 2^24 domain
        the five sets are about 20 GiB).  On one device `_segment_uploads`
        uploads the segments; on a mesh each rank uploads its block of one
        (`sharded_msm`, the bucket arrays all-gathered and merged).
        Segments whose scalars are all zero are skipped; the partials fold
        on the device."""
        n = len(bases)
        spans = [(ofs, min(ofs + seg, n)) for ofs in range(0, n, seg)
                 if bool(S_full[ofs:ofs + seg].any())]
        if self.mesh is None:
            parts = _segment_uploads(bases, spans, dc.device)

            def segment_msm(arrs, S):
                return msm(dc, arrs, S)
        else:
            parts = (tuple(a[ofs:hi] for a in (bases.x, bases.y, bases.z))
                     for ofs, hi in spans)

            def segment_msm(arrs, S):
                return pippenger.sharded_msm(dc, arrs, S, self.mesh,
                                             self.mesh_axis)
        total = None
        for arrs, (ofs, hi) in zip(parts, spans):
            out = tuple(a[None] for a in segment_msm(arrs, S_full[ofs:hi]))
            total = out if total is None else dc.add(total, out)
        if total is None:
            return gspec.infinity()
        return dc.decode_points(total)[0]

    # ----------------------------------------------------------------- verify

    def _public_sum(self, vk: VerifyingKey, public_inputs: list):
        """sum_i z_i [k_pub_i] over ONE and the publics, or None for a
        wrong count of publics."""
        z_pub = [1] + [x % self.r for x in public_inputs]
        if len(z_pub) != len(vk.k_pub_g1):
            return None
        pi = self.g1.infinity()
        for pt, s in zip(vk.k_pub_g1, z_pub):
            if s:
                pi = pi.add(pt.mul(s))
        return pi

    def verify(self, vk: VerifyingKey, proof: Proof, public_inputs: list) -> bool:
        """public_inputs: the circuit's public values (without the ONE)."""
        pi = self._public_sum(vk, public_inputs)
        if pi is None:
            return False
        return self._check(vk, proof, pi)

    def verify_committed(self, vk: VerifyingKey, proof: CommittedProof,
                         public_inputs: list) -> bool:
        """Verification with the commitment terms: the proof of knowledge
        pins D to the committed basis, and the challenge public is
        recomputed from D."""
        if vk.k_challenge_g1 is None or proof.d is None or proof.pok is None:
            return False
        # PoK: e(pok, G2) == e(D, [eta] G2)
        if not self.ctx.pairing_check(
            [(proof.pok, self.g2.gen), (proof.d.neg(), vk.eta_g2)]
        ):
            return False
        pi = self._public_sum(vk, public_inputs)
        if pi is None:
            return False
        challenge = self.commitment_challenge(proof.d)
        return self._check(
            vk, proof, pi.add(vk.k_challenge_g1.mul(challenge)).add(proof.d))

    def _check(self, vk: VerifyingKey, proof: Proof, pi) -> bool:
        """The Groth16 pairing equation, with `pi` on the gamma side."""
        return self.ctx.pairing_check(
            [
                (proof.a.neg(), proof.b),
                (vk.alpha_g1, vk.beta_g2),
                (pi, vk.gamma_g2),
                (proof.c, vk.delta_g2),
            ]
        )
