"""The reference side of the BW6-761 Groth16 tests: the reference's setup
(seeded) and prove (r = 5, s = 9) of the circuit of tests/test_bw6.py
give the bytes of tests/vectors/bw6_groth16.json, which the port's
setup (test_torch_bw6_setup.py) and prove (test_torch_bw6_groth16.py)
must equal."""

from davinci_tpu.groth16 import Groth16

import torch_bw6_cases as bw6


def test_reference_key_and_proof_equal_the_vector():
    g16 = Groth16("bw6_761")
    got = bw6.to_vector("davinci_tpu", g16,
                        *bw6.setup_and_prove(g16, "davinci_tpu"))
    assert got == bw6.vector()
