"""`Groth16("bw6_761", device="cpu").setup` of davinci_tpu_torch: from the
same seed, the proving and verifying keys of the circuit of
tests/test_bw6.py are the bytes of the reference's
(tests/vectors/bw6_groth16.json, `pk_to_bytes` and `vk_to_bytes`).  The
plain field at L = 64 (761-bit Fp, both groups over it) carries the
whole setup: about 25 s here."""

import random

import torch

from davinci_tpu_torch.groth16 import Groth16
from davinci_tpu_torch.groth16.serialize import pk_to_bytes, vk_to_bytes

import torch_bw6_cases as bw6

torch.set_num_threads(1)


def test_port_setup_equals_the_reference_key():
    g16 = Groth16("bw6_761", device="cpu")
    pk, vk = g16.setup(bw6.circuit("davinci_tpu_torch"),
                       rng=random.Random(bw6.SETUP_SEED))
    want = bw6.vector()
    assert vk_to_bytes(vk, g16.g1, g16.g2).hex() == want["vk"]
    assert pk_to_bytes(pk, g16.g1, g16.g2).hex() == want["pk"]
