"""`Groth16("bw6_761", device="cpu").prove` of davinci_tpu_torch: with the
reference's key (tests/vectors/bw6_groth16.json, read by the port's
`pk_from_bytes`) and r = 5, s = 9, the proof of the circuit of
tests/test_bw6.py is the reference's, point for point; it verifies for
y and not for y + 1."""

import torch

from davinci_tpu_torch.groth16 import Groth16
from davinci_tpu_torch.groth16.serialize import (
    pk_from_bytes,
    proof_to_dict,
    vk_from_bytes,
)

import torch_bw6_cases as bw6

torch.set_num_threads(1)


def test_port_proof_equals_the_reference_and_verifies():
    g16 = Groth16("bw6_761", device="cpu")
    want = bw6.vector()
    pk = pk_from_bytes(bytes.fromhex(want["pk"]), g16.g1, g16.g2)
    vk = vk_from_bytes(bytes.fromhex(want["vk"]), g16.g1, g16.g2)
    proof = g16.prove(pk, bw6.circuit("davinci_tpu_torch"),
                      r_rand=bw6.R_RAND, s_rand=bw6.S_RAND)
    assert proof_to_dict(proof) == want["proof"]
    assert g16.verify(vk, proof, [bw6.Y])
    assert not g16.verify(vk, proof, [bw6.Y + 1])
