"""The commitment challenge of davinci_tpu_torch's Groth16 held against the
JAX package, and the refusals around it, on the CPU.

`commitment_challenge` equals the reference's on BN254 (keccak) and
BLS12-377 (Poseidon over the G1 base field).  With the reference's key of
tests/test_lookup.py's range circuit carried across by `convert.py`, a
builder whose committed wires change with the challenge is refused, as
is a reuse prove of a system without the `_refinalize` hook: each as
`ProveError` (a ValueError and an AssertionError).
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
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16, ProveError

torch.set_num_threads(1)

VALUES = (3, 1, 2, 0)
TABLE_BITS = 2


def _build_range_circuit(CS, Checker, challenge, blind, values=VALUES):
    """tests/test_lookup.py's circuit: each value < 2^TABLE_BITS through the
    lookup, one public input (7) for the key's layout."""
    cs = CS(RF.BN254_R)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=TABLE_BITS)
    for v in values:
        rc.range_check(cs.priv_input(v), TABLE_BITS)
    rc.finalize(challenge, blind)
    cs.assert_eq(marker, cs.constant(7))
    return cs


@pytest.fixture(scope="module")
def run():
    """The reference's key (its conftest may serve it from disk), carried
    across."""
    port = Groth16("bn254", device="cpu")
    pk, _ = RefGroth16("bn254").setup(
        _build_range_circuit(RefCS, RefChecker, 0, 0))
    return dict(port=port,
                tpk=convert.proving_key_from_reference(pk, port.g1, port.g2))


@pytest.mark.parametrize("curve", ["bn254", "bls12_377"])
def test_commitment_challenge_matches_reference(curve):
    """keccak on BN254, Poseidon over the G1 base field elsewhere, for a
    few points and for infinity."""
    ref, port = RefGroth16(curve), Groth16(curve, device="cpu")
    rng = random.Random(5)
    pts = [ref.g1.infinity()] + [ref.g1.gen.mul(rng.randrange(1, ref.r))
                                 for _ in range(3)]
    for pt in pts:
        tpt = convert.point_from_reference(port.g1, pt)
        assert port.commitment_challenge(tpt) == ref.commitment_challenge(pt)


def test_committed_wires_that_follow_the_challenge_are_refused(run):
    """The reference's assertion, as ProveError (a ValueError and an
    AssertionError): a builder whose committed wires change with the
    challenge."""
    def build(challenge, blind):
        values = VALUES if challenge == 0 else (0,) + VALUES[1:]
        return _build_range_circuit(ConstraintSystem, LookupRangeChecker,
                                    challenge, blind, values=values)

    with pytest.raises(ProveError, match="depend on the challenge"):
        run["port"].prove_committed(run["tpk"], build, rng=random.Random(1))


def test_reuse_needs_the_refinalize_hook(run):
    cs = _build_range_circuit(ConstraintSystem, LookupRangeChecker, 0, 1)
    with pytest.raises(ProveError, match="_refinalize"):
        run["port"].prove_committed_reuse(run["tpk"], cs)
