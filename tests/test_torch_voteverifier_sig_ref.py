"""The reference's build of the vote verifier's signature half (the toy
c2 without the inner proof, tests/torch_c2_cases.py's `SIG_TIER`) from
the witness that both packages make: its counts, public value and
structure hash are `SIG_TIER_REFERENCE`, which the port's build in
test_torch_voteverifier_sig.py must equal."""

import torch
from torch_c2_cases import SIG_TIER, SIG_TIER_REFERENCE, build_one, fingerprint

from davinci_tpu.groth16.serialize import cs_structure_hash

torch.set_num_threads(1)


def test_reference_lite_c2_without_inner_proof_is_the_recorded_one():
    ref_cs, _ = build_one("davinci_tpu", SIG_TIER)
    assert fingerprint(ref_cs, cs_structure_hash) == SIG_TIER_REFERENCE
