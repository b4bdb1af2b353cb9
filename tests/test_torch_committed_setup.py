"""davinci_tpu_torch's own setup of a committed BN254 circuit, on the CPU.

From the default rng the port's setup gives the reference's key: every
base set, the commitment bases `k_commit_g1` and `k_commit_eta_g1`, and
the verifying key's `k_challenge_g1` and `eta_g2`.  The steady-state
`prove_committed_reuse` with that key is held in
test_torch_committed_reuse.py.
"""

import numpy as np
import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16

torch.set_num_threads(1)

BASES = ("a_g1", "b_g1", "b_g2", "k_g1", "z_g1", "k_commit_g1",
         "k_commit_eta_g1")
PK_POINTS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")
VK_POINTS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2",
             "k_challenge_g1", "eta_g2")


def _build(CS, Checker, challenge, blind):
    cs = CS(RF.BN254_R)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=2)
    for v in (3, 1, 2, 0):
        rc.range_check(cs.priv_input(v), 2)
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(7))
    return cs


def _coords(pt):
    return None if pt is None or pt.infinity else (pt.x.v, pt.y.v)


@pytest.fixture(scope="module")
def keys():
    cs = _build(ConstraintSystem, LookupRangeChecker, 0, 0)
    pk, vk = Groth16("bn254", device="cpu").setup(cs)
    ref_pk, ref_vk = RefGroth16("bn254").setup(_build(RefCS, RefChecker, 0, 0))
    return dict(pk=pk, vk=vk, ref_pk=ref_pk, ref_vk=ref_vk)


def test_setup_matches_reference_with_commitment_bases(keys):
    pk, ref = keys["pk"], keys["ref_pk"]
    assert len(pk.k_commit_g1) == 4 + 4 + 1  # values, multiplicities, blind
    for name in BASES:
        assert getattr(pk, name) == convert.bases_from_reference(getattr(ref, name))
    for name in PK_POINTS:
        assert _coords(getattr(pk, name)) == _coords(getattr(ref, name))
    assert np.array_equal(pk.a_indices, ref.a_indices)
    assert np.array_equal(pk.b_indices, ref.b_indices)
    assert pk.k_priv_indices == ref.k_priv_indices
    assert pk.domain_log == ref.domain_log
    vk, rvk = keys["vk"], keys["ref_vk"]
    for name in VK_POINTS:
        assert _coords(getattr(vk, name)) == _coords(getattr(rvk, name))
    assert [_coords(p) for p in vk.k_pub_g1] == [_coords(p) for p in rvk.k_pub_g1]
