"""The slice as a whole: davinci_tpu_torch Groth16 setup / prove / verify
held against the JAX package on the CPU.

One circuit is built in both packages.  The reference's setup is carried
across by `convert.py`; with the same r_rand/s_rand the two proofs must be
equal point for point and verify in both packages.  The package's own
setup, from the same (default) rng, must give the reference's key: equal bases,
points and indices (so its proofs are the ones above).
"""

import random

import numpy as np
import pytest
import torch

from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu_torch import convert
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16, ProveError
from davinci_tpu_torch.groth16.bases import EncodedBases

torch.set_num_threads(1)

R = TF.BN254_R
BASES = ("a_g1", "b_g1", "b_g2", "k_g1", "z_g1")
POINTS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")


def _circuit(CS, x, y):
    """x^3 + x + 5 == y (public y), with a product of two private wires
    so the A, B and C matrices each hold several variables."""
    cs = CS(R)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    w = cs.priv_input(x + 2)
    x3 = cs.mul(cs.mul(xv, xv), xv)
    cs.assert_eq(x3 + xv + 5, yv)
    cs.mul(w * 3 + xv, w + 1)
    return cs


def _coords(pt):
    if pt is None or pt.infinity:
        return None
    return (pt.x.v, pt.y.v)


@pytest.fixture(scope="module")
def keys():
    x = 3
    y = x**3 + x + 5
    ref, port = RefGroth16("bn254"), Groth16("bn254", device="cpu")
    rcs, tcs = _circuit(RefCS, x, y), _circuit(ConstraintSystem, x, y)
    # the default setup rng (both packages seed it alike); the suite's
    # conftest may serve the reference's key from its disk cache
    pk, vk = ref.setup(rcs)
    return dict(ref=ref, port=port, rcs=rcs, tcs=tcs, pk=pk, vk=vk, y=y)


def _port_proof(k):
    """The port's proof with the reference's key and r = 7, s = 11, made
    once per module."""
    if "proof" not in k:
        port = k["port"]
        pk = convert.proving_key_from_reference(k["pk"], port.g1, port.g2)
        k["proof"] = port.prove(pk, k["tcs"], r_rand=7, s_rand=11)
    return k["proof"]


def test_proofs_equal_with_the_reference_key(keys):
    k = keys
    port = k["port"]
    vk = convert.verifying_key_from_reference(k["vk"], port.g1, port.g2)
    want = k["ref"].prove(k["pk"], k["rcs"], r_rand=7, s_rand=11)
    got = _port_proof(k)
    for part in ("a", "b", "c"):
        assert _coords(getattr(got, part)) == _coords(getattr(want, part))
    assert k["ref"].verify(k["vk"], want, [k["y"]])
    assert port.verify(vk, got, [k["y"]])
    assert not port.verify(vk, got, [k["y"] + 1])


def test_setup_matches_reference(keys):
    k = keys
    pk, vk = k["port"].setup(k["tcs"])
    for name in BASES:
        assert getattr(pk, name) == convert.bases_from_reference(getattr(k["pk"], name))
    for name in POINTS:
        assert _coords(getattr(pk, name)) == _coords(getattr(k["pk"], name))
    assert np.array_equal(pk.a_indices, k["pk"].a_indices)
    assert np.array_equal(pk.b_indices, k["pk"].b_indices)
    assert pk.k_priv_indices == k["pk"].k_priv_indices
    assert pk.domain_log == k["pk"].domain_log
    assert [_coords(p) for p in vk.k_pub_g1] == [_coords(p) for p in k["vk"].k_pub_g1]
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert _coords(getattr(vk, name)) == _coords(getattr(k["vk"], name))


def test_unsatisfied_witness_rejected(keys):
    k = keys
    port = k["port"]
    pk = convert.proving_key_from_reference(k["pk"], port.g1, port.g2)
    bad = _circuit(ConstraintSystem, 3, 99)
    with pytest.raises(ValueError):
        port.prove(pk, bad)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_segmented_msm_matches_host(keys, group, monkeypatch):
    """Sets above the segment size run as segments whose partials fold on
    the device; a segment of zero scalars is skipped."""
    port = keys["port"]
    spec = getattr(port, group)
    dc = port.dc if group == "g1" else port.dc2
    rng = random.Random(21)
    pts = [spec.gen.mul(rng.randrange(1, spec.r)) for _ in range(5)]
    scalars = [rng.randrange(spec.r) for _ in pts]
    scalars[2] = scalars[3] = 0
    bases = EncodedBases.from_device(dc.affine_encoding(dc.encode_points(pts)))
    monkeypatch.setattr(port, "MSM_SEGMENT", 2)
    monkeypatch.setattr(port, "MSM_SEGMENT_G2", 2)
    want = spec.infinity()
    for p, k in zip(pts, scalars):
        want = want.add(p.mul(k))
    assert port._msm_enc(dc, spec, bases, scalars) == want


def _refusals(keys, monkeypatch):
    """The three refusals of a prove: an unsatisfied witness, a quotient
    of too high a degree, bases and scalars of different counts."""
    k = keys
    port = k["port"]
    pk = convert.proving_key_from_reference(k["pk"], port.g1, port.g2)

    def unsatisfied():
        port.prove(pk, _circuit(ConstraintSystem, 3, 99))

    def overflow():
        # a quotient whose top coefficient is not zero
        real = port.ntt.df.from_mont
        monkeypatch.setattr(port.ntt.df, "from_mont",
                            lambda a: torch.ones_like(real(a)))
        try:
            port.prove(pk, _circuit(ConstraintSystem, 3, 35))
        finally:
            monkeypatch.setattr(port.ntt.df, "from_mont", real)

    def counts():
        port._msm_enc(port.dc, port.g1, pk.a_g1, [1] * (len(pk.a_g1) + 1))

    return {"unsatisfied": unsatisfied, "overflow": overflow, "counts": counts}


@pytest.mark.parametrize("case", ["unsatisfied", "overflow", "counts"])
@pytest.mark.parametrize("kind", [ValueError, AssertionError])
def test_refusals_are_both_error_types(keys, monkeypatch, case, kind):
    """The reference asserts where the port raises ProveError, which is
    both a ValueError and an AssertionError."""
    with pytest.raises(kind) as err:
        _refusals(keys, monkeypatch)[case]()
    assert type(err.value) is ProveError


def test_explicit_pairing_and_field_give_the_same_proof(keys):
    """Groth16(name, ctx, fr) as in the reference: BN254's own (ctx, fr)
    passed explicitly prove as the name does."""
    from davinci_tpu_torch.pairing import PAIRINGS

    k = keys
    port = k["port"]
    explicit = Groth16("bn254", PAIRINGS["bn254"], TF.bn254_fr, device="cpu")
    assert explicit.ctx is port.ctx and explicit.fr is port.fr
    pk = convert.proving_key_from_reference(k["pk"], port.g1, port.g2)
    want = _port_proof(k)
    got = explicit.prove(pk, k["tcs"], r_rand=7, s_rand=11)
    for part in ("a", "b", "c"):
        assert _coords(getattr(got, part)) == _coords(getattr(want, part))
