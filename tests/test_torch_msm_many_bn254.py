"""`msm_many` of davinci_tpu_torch on BN254 G1, the proving curve, by
both routes of tests/torch_msm_many_cases.py (the plain one CPU tensors
take, and the card's with its kernels' plain versions), held against the
JAX package on the CPU.  Tolerance: exact equality of limbs and points.
"""

import torch

import torch_msm_many_cases as cases

torch.set_num_threads(1)


def test_msm_many_plain_route_matches_reference():
    cases.check_plain_route("bn254_g1")


def test_msm_many_scan_route_matches_reference(monkeypatch):
    cases.check_scan_route("bn254_g1", monkeypatch)
