"""The commitment extension of davinci_tpu_torch's Groth16 held against the
JAX package on BN254, on the CPU.

The lookup range circuit of tests/test_lookup.py is built in both
packages, at a 4-entry table so the CPU proves stay cheap.  With the
reference's key carried across by `convert.py`, random.Random(11), r = 5
and s = 9, the port's `prove_committed` gives the reference's proof point
for point (a, b, c, D and pok).  The challenge and the refusals,
verification, the `_refinalize` hook, setup and `prove_committed_reuse`
are held in test_torch_committed_challenge.py, _verify.py, _setup.py and
_reuse.py: one CPU prove costs about 15 s, so each file holds one.
"""

import random

import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
from davinci_tpu_torch.groth16 import (CommittedProof, ConstraintSystem,
                                       Groth16)

torch.set_num_threads(1)

VALUES = (3, 1, 2, 0)
TABLE_BITS = 2


def _build_range_circuit(CS, Checker, challenge, blind):
    """tests/test_lookup.py's circuit: each value < 2^TABLE_BITS through the
    lookup, one public input (7) for the key's layout."""
    cs = CS(RF.BN254_R)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=TABLE_BITS)
    for v in VALUES:
        rc.range_check(cs.priv_input(v), TABLE_BITS)
    rc.finalize(challenge, blind)
    cs.assert_eq(marker, cs.constant(7))
    return cs


def _coords(pt):
    return None if pt.infinity else (pt.x.v, pt.y.v)


@pytest.fixture(scope="module")
def run():
    """The reference's proof with its key (its conftest may serve the key
    from disk), and the port's with the key carried across."""
    ref = RefGroth16("bn254")
    port = Groth16("bn254", device="cpu")
    pk, _ = ref.setup(_build_range_circuit(RefCS, RefChecker, 0, 0))
    want = ref.prove_committed(
        pk, lambda c, b: _build_range_circuit(RefCS, RefChecker, c, b),
        rng=random.Random(11), r_rand=5, s_rand=9)
    tpk = convert.proving_key_from_reference(pk, port.g1, port.g2)
    got = port.prove_committed(
        tpk, lambda c, b: _build_range_circuit(ConstraintSystem,
                                               LookupRangeChecker, c, b),
        rng=random.Random(11), r_rand=5, s_rand=9)
    return dict(want=want, got=got)


@pytest.mark.parametrize("part", ["a", "b", "c", "d", "pok"])
def test_committed_proof_equals_reference(run, part):
    assert isinstance(run["got"], CommittedProof)
    assert _coords(getattr(run["got"], part)) == _coords(getattr(run["want"], part))
