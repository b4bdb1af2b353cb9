"""Plain Groth16 on BLS12-381 in davinci_tpu_torch, held against the JAX
package on the CPU: with the reference's key carried across and r = 7,
s = 11, the port's proof equals the reference's point for point and
verifies true for the right public input and false for another.
"""

import torch

from davinci_tpu import fields as RF
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu_torch import convert
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16

torch.set_num_threads(1)


def _cubic(CS, x, y):
    cs = CS(RF.BLS12_381_R)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    w = cs.priv_input(x + 2)
    x3 = cs.mul(cs.mul(xv, xv), xv)
    cs.assert_eq(x3 + xv + 5, yv)
    cs.mul(w * 3 + xv, w + 1)
    return cs


def test_bls12_381_proof_equals_reference():
    ref, port = RefGroth16("bls12_381"), Groth16("bls12_381", device="cpu")
    pk, vk = ref.setup(_cubic(RefCS, 3, 35))
    want = ref.prove(pk, _cubic(RefCS, 3, 35), r_rand=7, s_rand=11)
    tpk = convert.proving_key_from_reference(pk, port.g1, port.g2)
    tvk = convert.verifying_key_from_reference(vk, port.g1, port.g2)
    got = port.prove(tpk, _cubic(ConstraintSystem, 3, 35), r_rand=7, s_rand=11)
    for part in ("a", "b", "c"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g.x.v, g.y.v) == (w.x.v, w.y.v)
    assert port.verify(tvk, got, [35])
    assert not port.verify(tvk, got, [36])
