"""The signature half of the vote verifier (c2) built by the port from the
witness that both packages make (tests/torch_c2_cases.py): the toy c2's
lite tier without the inner proof, with the native vote hash, so what it
holds is the emulated ECDSA over the EIP-191 vote-id message, the keccak
gadget, the address binding and the lookup range checks (436,938
constraints).  Its counts, public value and structure hash must be those
of the reference's build, `SIG_TIER_REFERENCE`, which
test_torch_voteverifier_sig_ref.py makes again from the reference (the
two builds run in two files to keep each under half a minute).  The
inner-proof half is test_torch_voteverifier.py's."""

import torch
from torch_c2_cases import SIG_TIER, SIG_TIER_REFERENCE, build_one, fingerprint

torch.set_num_threads(1)


def test_lite_c2_without_inner_proof_equals_the_reference():
    cs, w = build_one("davinci_tpu_torch", SIG_TIER)
    assert fingerprint(cs) == SIG_TIER_REFERENCE
    assert cs.check_satisfied(), cs.first_unsatisfied()
    # the address wire is bound to the signer's key
    idx = cs.values.index(w.address, 1)
    cs.values[idx] = (w.address + 1) % cs.p
    assert not cs.check_satisfied()
