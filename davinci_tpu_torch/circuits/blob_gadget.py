"""In-circuit EIP-4844 blob evaluation: barycentric KZG evaluation over
EMULATED BLS12-381 Fr inside a BN254 circuit.

Role parity: reference crypto/blobs/evaluation.go:61-147
(VerifyBarycentricEvaluation): the state-transition circuit proves the
blob polynomial evaluates to y at the challenge z:

    y = (z^N - 1)/N * sum_i d_i * w_i / (z - w_i)

Hint structure mirrors the reference (hints.go:20-88): the per-cell
quotients q_i = d_i / (z - w_i) are hint-allocated and each checked with
ONE emulated multiplication q_i * (z - w_i) == d_i; the weighted sum
sum q_i * w_i is a single EmulatedOps.lincomb (the w_i are constants), so
the total cost is ~1 emulated mul per cell — the same asymptotics as the
reference's gnark version.

The domain size is a parameter: production uses the 4096-cell blob domain
(~4M constraints at 3-limb BLS381-Fr-in-BN254 — gated); CI exercises the
identical code on small domains with a host-side oracle.
"""

from __future__ import annotations

from davinci_tpu_torch import fields as F
from davinci_tpu_torch.circuits.emulated import EmulatedOps

_R381 = F.BLS12_381_R


def barycentric_eval_host(domain: list, data: list, z: int) -> int:
    """Host oracle: y = (z^N - 1)/N * sum d_i w_i / (z - w_i); if z is in
    the domain, y is the matching d_i."""
    n = len(domain)
    z %= _R381
    for w, d in zip(domain, data):
        if w == z:
            return d % _R381
    acc = 0
    for w, d in zip(domain, data):
        acc = (acc + d * w % _R381 * pow((z - w) % _R381, -1, _R381)) % _R381
    zn = (pow(z, n, _R381) - 1) % _R381
    return zn * pow(n, -1, _R381) % _R381 * acc % _R381


def blob_eval(cs, E: EmulatedOps, domain: list, data_vars: list, z_var, y_var):
    """Assert y == barycentric(data, z).  ~2 emulated muls per cell plus
    one lincomb; a domain hit (z == w_i) is UNSATISFIABLE (the challenge
    is hash-derived, so this is a negligible completeness event, never a
    soundness hole)."""
    n = len(domain)
    quotients = []
    for w, d in zip(domain, data_vars):
        # q = d * (z - w)^-1; inv() forces the denominator nonzero
        denom = E.sub(z_var, E.constant(w))
        q = E.mul(d, E.inv(denom))
        quotients.append(q)
    # sum q_i * w_i: constants on one side -> single carry check
    s = E.lincomb([(q, w) for q, w in zip(quotients, domain)])
    # (z^N - 1)/N: square-and-multiply on the emulated element (N is a
    # power of two: log2(N) squarings)
    zn = z_var
    k = n
    assert k & (k - 1) == 0, "domain size must be a power of two"
    while k > 1:
        zn = E.square(zn)
        k >>= 1
    factor = E.cmul(
        E.sub(zn, E.one), pow(n, -1, _R381)
    )
    E.assert_eq(E.mul(factor, s), y_var)
