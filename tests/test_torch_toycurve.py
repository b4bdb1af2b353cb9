"""The toy BLS12 curve (`circuits/toycurve.py`, a verbatim copy) and a
Groth16 over it, held against the JAX package on the CPU.

The curve's parameters and generators must be the reference's.  Its Fr
has L = 5 limbs, which the port serves on the CPU only, so the port's
backend is built with `device="cpu"`; `toy_groth16()` itself builds on the
default device.  The key of the tiny circuit of
tests/test_voteverifier_circuit.py (x^2 = h, h public), from the same
default setup rng, and the proof with r = 3, s = 5 must equal the
reference's point for point, and verify in both packages.  That key and
proof are the inner proof of the toy vote verifier's tests
(tests/vectors/c2_inner_toy.json), which must be the reference's.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from davinci_tpu.circuits.toycurve import toy_bls12 as ref_toy_bls12
from davinci_tpu.circuits.toycurve import toy_groth16 as ref_toy_groth16
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16.serialize import proof_to_dict, vk_to_bytes
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.toycurve import toy_bls12, toy_groth16
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16

torch.set_num_threads(1)

BASES = ("a_g1", "b_g1", "b_g2", "k_g1", "z_g1")
POINTS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")


def _coords(pt):
    if pt is None or pt.infinity:
        return None
    return (pt.x.v, pt.y.v)


def _circuit(CS, r):
    """tests/test_voteverifier_circuit.py:29-36: h = x^2, h public."""
    rng = random.Random(97)
    x_v = rng.randrange(2, r)
    cs = CS(r)
    h = cs.pub_input(x_v * x_v % r)
    x = cs.priv_input(x_v)
    cs.assert_eq(cs.mul(x, x), h)
    return cs


@pytest.fixture(scope="module")
def toy():
    t, ref_t = toy_bls12(), ref_toy_bls12()
    ref = ref_toy_groth16()
    port = Groth16("toy_bls12", ctx=t["ctx"], fr=t["fr_spec"], device="cpu")
    rcs, tcs = _circuit(RefCS, ref_t["r"]), _circuit(ConstraintSystem, t["r"])
    pk, vk = ref.setup(rcs)
    return dict(t=t, ref_t=ref_t, ref=ref, port=port, rcs=rcs, tcs=tcs,
                pk=pk, vk=vk)


def test_curve_parameters_equal_the_reference(toy):
    t, ref_t = toy["t"], toy["ref_t"]
    for key in ("x", "p", "r"):
        assert t[key] == ref_t[key]
    for g in ("g1", "g2"):
        assert t[g].r == ref_t[g].r
        assert repr(t[g].gen.x.v) == repr(ref_t[g].gen.x.v)
        assert repr(t[g].gen.y.v) == repr(ref_t[g].gen.y.v)
    assert (t["fr_spec"].num_limbs, t["fp_spec"].num_limbs) == (5, 8)
    assert t["ctx"].loop_count == ref_t["ctx"].loop_count


def test_key_equals_the_reference(toy):
    k = toy
    pk, vk = k["port"].setup(k["tcs"])
    for name in BASES:
        assert getattr(pk, name) == convert.bases_from_reference(
            getattr(k["pk"], name))
    for name in POINTS:
        assert _coords(getattr(pk, name)) == _coords(getattr(k["pk"], name))
    assert np.array_equal(pk.a_indices, k["pk"].a_indices)
    assert np.array_equal(pk.b_indices, k["pk"].b_indices)
    assert pk.domain_log == k["pk"].domain_log
    assert [_coords(p) for p in vk.k_pub_g1] == [
        _coords(p) for p in k["vk"].k_pub_g1]
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert _coords(getattr(vk, name)) == _coords(getattr(k["vk"], name))


def test_proof_equals_the_reference(toy):
    k = toy
    port = k["port"]
    pk = convert.proving_key_from_reference(k["pk"], port.g1, port.g2)
    vk = convert.verifying_key_from_reference(k["vk"], port.g1, port.g2)
    want = k["ref"].prove(k["pk"], k["rcs"], r_rand=3, s_rand=5)
    got = port.prove(pk, k["tcs"], r_rand=3, s_rand=5)
    for part in ("a", "b", "c"):
        assert _coords(getattr(got, part)) == _coords(getattr(want, part))
    public = k["tcs"].public_values()
    assert k["ref"].verify(k["vk"], want, public)
    assert port.verify(vk, got, public)
    assert not port.verify(vk, got, [public[0] + 1])


def test_c2_inner_vector_is_the_reference_proof(toy):
    vector = json.loads((Path(__file__).parent / "vectors"
                         / "c2_inner_toy.json").read_text())
    ref_t = toy["ref_t"]
    assert vk_to_bytes(toy["vk"], ref_t["g1"], ref_t["g2"]).hex() == (
        vector["vk"])
    proof = toy["ref"].prove(toy["pk"], toy["rcs"], r_rand=3, s_rand=5)
    assert proof_to_dict(proof) == vector["proof"]


def test_toy_groth16_builds_on_the_default_device():
    """`toy_groth16()` is the reference's text: its backend is on the
    default device, the card, so without one (or, on a card, for an Fr
    with no kernel build) it raises instead of proving on the CPU."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            toy_groth16()
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            toy_groth16()
