"""Carry a proving and verifying key of the reference package across.

`proving_key_from_reference` / `verifying_key_from_reference` map the
reference's ProvingKey and VerifyingKey (numpy EncodedBases and host
AffinePoints) to this package's, through plain ints and numpy arrays.  The
reference objects are read by their attributes only, so this module
imports nothing of the reference: the same key can prove in both
packages.
"""

from __future__ import annotations

import numpy as np

from davinci_tpu_torch.curves import AffinePoint
from davinci_tpu_torch.groth16.bases import EncodedBases
from davinci_tpu_torch.groth16.core import ProvingKey, VerifyingKey
from davinci_tpu_torch.towers import FF


def point_from_reference(spec, pt):
    """A reference AffinePoint -> the same point on this package's curve
    `spec` (coordinates as plain ints, or (c0, c1) int pairs over Fp2)."""
    if pt is None:
        return None
    if pt.infinity:
        return spec.infinity()
    if hasattr(spec.fld, "p"):
        return AffinePoint(spec, spec.fld(int(pt.x.v)), spec.fld(int(pt.y.v)))
    x = tuple(int(c) for c in pt.x.v)
    y = tuple(int(c) for c in pt.y.v)
    return AffinePoint(spec, FF(spec.fld, x), FF(spec.fld, y))


def bases_from_reference(bases):
    if bases is None:
        return None
    return EncodedBases(np.array(bases.x), np.array(bases.y), np.array(bases.z))


def _indices(ix):
    return None if ix is None else np.asarray(ix, np.int64).copy()


def proving_key_from_reference(pk, g1, g2) -> ProvingKey:
    """g1/g2: this package's CurveSpecs of the key's curve."""
    return ProvingKey(
        alpha_g1=point_from_reference(g1, pk.alpha_g1),
        beta_g1=point_from_reference(g1, pk.beta_g1),
        beta_g2=point_from_reference(g2, pk.beta_g2),
        delta_g1=point_from_reference(g1, pk.delta_g1),
        delta_g2=point_from_reference(g2, pk.delta_g2),
        a_g1=bases_from_reference(pk.a_g1),
        b_g1=bases_from_reference(pk.b_g1),
        b_g2=bases_from_reference(pk.b_g2),
        k_g1=bases_from_reference(pk.k_g1),
        z_g1=bases_from_reference(pk.z_g1),
        domain_log=int(pk.domain_log),
        a_indices=_indices(pk.a_indices),
        b_indices=_indices(pk.b_indices),
        k_commit_g1=bases_from_reference(pk.k_commit_g1),
        k_commit_eta_g1=bases_from_reference(pk.k_commit_eta_g1),
        k_priv_indices=(
            None if pk.k_priv_indices is None
            else [int(i) for i in pk.k_priv_indices]
        ),
    )


def verifying_key_from_reference(vk, g1, g2) -> VerifyingKey:
    return VerifyingKey(
        alpha_g1=point_from_reference(g1, vk.alpha_g1),
        beta_g2=point_from_reference(g2, vk.beta_g2),
        gamma_g2=point_from_reference(g2, vk.gamma_g2),
        delta_g2=point_from_reference(g2, vk.delta_g2),
        k_pub_g1=[point_from_reference(g1, p) for p in vk.k_pub_g1],
        k_challenge_g1=point_from_reference(g1, vk.k_challenge_g1),
        eta_g2=point_from_reference(g2, vk.eta_g2),
    )
