"""`msm_many`'s plain route on BLS12-381 G1 (the route CPU tensors take)
and `msm_host_input` on BLS12-381 and BN254 G1, of davinci_tpu_torch,
held against the JAX package on the CPU with the cases of
tests/torch_msm_many_cases.py.  Tolerance: exact equality of limbs and
points.
"""

import pytest
import torch

import torch_msm_many_cases as cases

torch.set_num_threads(1)


def test_msm_many_plain_route_matches_reference():
    cases.check_plain_route("bls381_g1")


@pytest.mark.parametrize("name", ["bls381_g1", "bn254_g1"])
def test_msm_host_input_matches_reference(name):
    cases.check_host_input(name)
