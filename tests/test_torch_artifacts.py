"""davinci_tpu_torch's `groth16/serialize.py` held against the JAX package's
bytes on the CPU: the `pk.bin`, `vk.bin` and `.solved` formats of the
boundary contract.

Keys are the reference's (its conftest may serve them from disk), of a
plain circuit and of a committed one (tests/test_artifacts.py's cubic and
tests/test_lookup.py's range circuit).  Carried across by `convert.py`,
they serialize to the reference's bytes, and the port reads the
reference's bytes into equal bases, points and indices.  Proof dicts and
structure hashes are equal; solved systems give equal bytes and load
across in both directions; a solved system loaded from the reference's
bytes re-proves committed and verifies (tests/test_serialize_solved.py).
A loaded system is not serialized again: the copy carries the
reference's fault there (its refinalize block is dropped).
"""

import json
import random

import numpy as np
import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16 import core as ref_core
from davinci_tpu.groth16 import serialize as ref_ser
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
from davinci_tpu_torch.groth16 import (CommittedProof, ConstraintSystem,
                                       Groth16, Proof)
from davinci_tpu_torch.groth16 import serialize as ser

torch.set_num_threads(1)

BASES = ("a_g1", "b_g1", "b_g2", "k_g1", "z_g1", "k_commit_g1",
         "k_commit_eta_g1")
PK_POINTS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")
VK_POINTS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2",
             "k_challenge_g1", "eta_g2")


def _cubic(CS, x, y):
    cs = CS(RF.BN254_R)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    x3 = cs.mul(cs.mul(xv, xv), xv)
    cs.assert_eq(x3 + xv + 5, yv)
    return cs


def _range(CS, Checker, challenge=0, blind=0):
    cs = CS(RF.BN254_R)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=2)
    for v in (3, 1, 2, 0):
        rc.range_check(cs.priv_input(v), 2)
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(7))
    return cs


CIRCUITS = {
    "plain": (lambda: _cubic(RefCS, 3, 35), lambda: _cubic(ConstraintSystem, 3, 35)),
    "committed": (lambda: _range(RefCS, RefChecker, 0xABCDEF, 11),
                  lambda: _range(ConstraintSystem, LookupRangeChecker,
                                 0xABCDEF, 11)),
}


def _coords(pt):
    return None if pt is None or pt.infinity else (pt.x.v, pt.y.v)


@pytest.fixture(scope="module")
def ctx():
    ref, port = RefGroth16("bn254"), Groth16("bn254", device="cpu")
    keys = {name: ref.setup(make_ref()) for name, (make_ref, _) in CIRCUITS.items()}
    return dict(ref=ref, port=port, keys=keys)


def _port_keys(c, name):
    pk, vk = c["keys"][name]
    port = c["port"]
    return (convert.proving_key_from_reference(pk, port.g1, port.g2),
            convert.verifying_key_from_reference(vk, port.g1, port.g2))


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_key_bytes_equal_reference(ctx, name):
    ref, port = ctx["ref"], ctx["port"]
    pk, vk = ctx["keys"][name]
    tpk, tvk = _port_keys(ctx, name)
    assert (ser.pk_to_bytes(tpk, port.g1, port.g2)
            == ref_ser.pk_to_bytes(pk, ref.g1, ref.g2))
    assert (ser.vk_to_bytes(tvk, port.g1, port.g2)
            == ref_ser.vk_to_bytes(vk, ref.g1, ref.g2))


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_port_reads_reference_bytes(ctx, name):
    ref, port = ctx["ref"], ctx["port"]
    pk, vk = ctx["keys"][name]
    got = ser.pk_from_bytes(ref_ser.pk_to_bytes(pk, ref.g1, ref.g2),
                            port.g1, port.g2)
    for attr in BASES:
        assert getattr(got, attr) == convert.bases_from_reference(getattr(pk, attr))
    for attr in PK_POINTS:
        assert _coords(getattr(got, attr)) == _coords(getattr(pk, attr))
    assert np.array_equal(got.a_indices, pk.a_indices)
    assert np.array_equal(got.b_indices, pk.b_indices)
    assert got.k_priv_indices == pk.k_priv_indices
    assert got.domain_log == pk.domain_log
    gvk = ser.vk_from_bytes(ref_ser.vk_to_bytes(vk, ref.g1, ref.g2),
                            port.g1, port.g2)
    for attr in VK_POINTS:
        assert _coords(getattr(gvk, attr)) == _coords(getattr(vk, attr))
    assert [_coords(p) for p in gvk.k_pub_g1] == [_coords(p) for p in vk.k_pub_g1]


@pytest.mark.parametrize("committed", [False, True])
def test_proof_dicts_equal_reference(ctx, committed):
    """Proofs made of key points (no prove needed): the same JSON dict, and
    the port's dict reads back into the same points."""
    ref, port = ctx["ref"], ctx["port"]
    pk, _ = ctx["keys"]["committed"]
    tpk, _ = _port_keys(ctx, "committed")
    parts = dict(a=pk.alpha_g1, b=pk.beta_g2, c=pk.delta_g1)
    tparts = dict(a=tpk.alpha_g1, b=tpk.beta_g2, c=tpk.delta_g1)
    if committed:
        parts.update(d=pk.beta_g1, pok=ref.g1.infinity())
        tparts.update(d=tpk.beta_g1, pok=port.g1.infinity())
        want = ref_ser.proof_to_dict(ref_core.CommittedProof(**parts))
        got = ser.proof_to_dict(CommittedProof(**tparts))
    else:
        want = ref_ser.proof_to_dict(ref_core.Proof(**parts))
        got = ser.proof_to_dict(Proof(**tparts))
    assert got == want
    back = ser.proof_from_dict(json.loads(json.dumps(got)), port.g1, port.g2)
    assert isinstance(back, CommittedProof) is committed
    for key, pt in tparts.items():
        assert getattr(back, key) == pt


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_structure_hash_equals_reference(name):
    make_ref, make_port = CIRCUITS[name]
    assert ser.cs_structure_hash(make_port()) == ref_ser.cs_structure_hash(make_ref())


def _loaded_state(lo):
    refin = getattr(lo, "_refinalize", None)
    state = None if refin is None else (
        refin.tb, refin._gamma_idx, list(refin._inv_idx),
        list(refin._prod_idx), list(refin._m_idx), list(refin._checked_vals))
    return (lo.p, lo.num_public, list(lo.values), list(lo.committed),
            lo.challenge_idx, len(lo.constraints),
            [(i.tolist(), [int(x) for x in c], o.tolist())
             for i, c, o in lo._flat_matrices()], state)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_solved_bytes_equal_in_both_directions(name):
    make_ref, make_port = CIRCUITS[name]
    want, got = ref_ser.solved_to_bytes(make_ref()), ser.solved_to_bytes(make_port())
    assert got == want
    port_lo, ref_lo = ser.solved_from_bytes(want), ref_ser.solved_from_bytes(got)
    assert isinstance(port_lo, ser.SolvedSystem)
    assert _loaded_state(port_lo) == _loaded_state(ref_lo)
    assert (getattr(port_lo, "_refinalize", None) is None) is (name == "plain")
    assert port_lo.check_satisfied()


def test_solved_system_from_reference_bytes_proves_reuse(ctx):
    """The elasticity path: the reference's `.solved` bytes, loaded by the
    port, re-prove committed with no builder and verify."""
    port = ctx["port"]
    tpk, tvk = _port_keys(ctx, "committed")
    blob = ref_ser.solved_to_bytes(_range(RefCS, RefChecker, 12345678, 4))
    lo = ser.solved_from_bytes(blob)
    proof = port.prove_committed_reuse(tpk, lo, rng=random.Random(7),
                                       r_rand=11, s_rand=13)
    assert lo.values[lo.challenge_idx] == port.commitment_challenge(proof.d)
    assert port.verify_committed(tvk, proof, lo.public_values())
