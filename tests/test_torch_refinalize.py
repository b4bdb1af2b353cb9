"""The committed prove's re-solve of the challenge's wires in
davinci_tpu_torch (`LookupRangeChecker.refinalize` and a loaded system's
`_LoadedRefinalize`), held against the JAX package's, on the CPU.

The port inverts every denominator in one batch (`batch_inverse`,
Montgomery's trick) where the reference takes one modular inverse each;
the solved values must be the same integers.
"""

import random

import pytest

from davinci_tpu import fields as RF
from davinci_tpu.circuits.lookup import LookupRangeChecker as RefChecker
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu_torch import fields as F
from davinci_tpu_torch.circuits.lookup import LookupRangeChecker, batch_inverse
from davinci_tpu_torch.groth16 import ConstraintSystem
from davinci_tpu_torch.groth16.serialize import (
    solved_from_bytes,
    solved_to_bytes,
)

TABLE_BITS = 4
CHALLENGES = (1 << TABLE_BITS, 0xC0FFEE << 100, F.BN254_R - 1)


def _build(CS, Checker, p, challenge=0, blind=3):
    """Thirty 4-bit values, five 10-bit ones (chunked, the top chunk
    shifted) and a public marker, with the `_refinalize` hook."""
    rng = random.Random(0x1F)
    cs = CS(p)
    marker = cs.pub_input(7)
    rc = Checker(cs, table_bits=TABLE_BITS)
    for _ in range(30):
        rc.range_check(cs.priv_input(rng.randrange(1 << TABLE_BITS)),
                       TABLE_BITS)
    for _ in range(5):
        rc.range_check(cs.priv_input(rng.randrange(1 << 10)), 10)
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(7))
    return cs


@pytest.mark.parametrize("p", [F.BN254_R, F.BLS12_377_R])
def test_batch_inverse_equals_pow(p):
    rng = random.Random(p & 0xFFFF)
    xs = [1, p - 1, 2] + [rng.randrange(1, p) for _ in range(200)]
    assert batch_inverse(xs, p) == [pow(x, -1, p) for x in xs]
    assert batch_inverse([], p) == []


def test_batch_inverse_refuses_zero():
    with pytest.raises(ValueError):
        batch_inverse([3, 0, 5], F.BN254_R)


@pytest.mark.parametrize("challenge", CHALLENGES)
def test_refinalize_matches_reference(challenge):
    ref = _build(RefCS, RefChecker, RF.BN254_R)
    port = _build(ConstraintSystem, LookupRangeChecker, F.BN254_R)
    assert port.values == ref.values
    ref._refinalize(challenge)
    port._refinalize(challenge)
    assert port.values == ref.values
    assert port.check_satisfied()


@pytest.mark.parametrize("challenge", CHALLENGES)
def test_loaded_refinalize_matches_reference(challenge):
    """A solved system saved and loaded re-solves as the reference's
    built one does."""
    ref = _build(RefCS, RefChecker, RF.BN254_R)
    loaded = solved_from_bytes(solved_to_bytes(
        _build(ConstraintSystem, LookupRangeChecker, F.BN254_R)))
    ref._refinalize(challenge)
    loaded._refinalize(challenge)
    assert loaded.values == ref.values
    assert loaded.check_satisfied()
