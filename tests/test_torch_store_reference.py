"""A store directory written by the JAX package's artifact store, loaded by
davinci_tpu_torch's store on the CPU.

The port's store loads the reference's directory with no setup (the
store catches an unreadable key and sets up afresh, which would hide a
reader that cannot read the reference's bytes, so setup is forbidden),
the loaded key serializes to the reference's bytes, and a proof of the
port with it verifies in the reference's runtime.  The other direction
is held in test_torch_store.py.
"""

import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.artifacts import ArtifactStore as RefStore
from davinci_tpu.curves import AffinePoint as RefPoint
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16 import core as ref_core
from davinci_tpu.groth16 import serialize as ref_ser
from davinci_tpu.towers import FF as RefFF
from davinci_tpu_torch.circuits.artifacts import ArtifactStore
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16
from davinci_tpu_torch.groth16.serialize import pk_to_bytes

torch.set_num_threads(1)


def _cubic(CS, x, y):
    cs = CS(RF.BN254_R)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    x3 = cs.mul(cs.mul(xv, xv), xv)
    cs.assert_eq(x3 + xv + 5, yv)
    return cs


def _to_reference(spec, pt):
    if hasattr(spec.fld, "p"):
        return RefPoint(spec, spec.fld(pt.x.v), spec.fld(pt.y.v))
    return RefPoint(spec, RefFF(spec.fld, tuple(pt.x.v)),
                    RefFF(spec.fld, tuple(pt.y.v)))


def test_reference_directory_loads_in_port_store(tmp_path, monkeypatch):
    ref = RefGroth16("bn254")
    ref_rt = RefStore(tmp_path).load_or_setup("cubic", "bn254",
                                              _cubic(RefCS, 3, 35), g16=ref)

    def refuse(*args, **kwargs):
        raise AssertionError("a setup ran where the key should load")

    monkeypatch.setattr(Groth16, "setup", refuse)
    cs = _cubic(ConstraintSystem, 3, 35)
    rt = ArtifactStore(tmp_path).load_or_setup(
        "cubic", "bn254", cs, g16=Groth16("bn254", device="cpu"))
    g1, g2 = rt.g16.g1, rt.g16.g2
    assert pk_to_bytes(rt.pk, g1, g2) == ref_ser.pk_to_bytes(ref_rt.pk, ref.g1, ref.g2)
    proof = rt.prove_and_verify(cs, r_rand=5, s_rand=9)
    ref_proof = ref_core.Proof(a=_to_reference(ref.g1, proof.a),
                               b=_to_reference(ref.g2, proof.b),
                               c=_to_reference(ref.g1, proof.c))
    assert ref_rt.verify(ref_proof, [35])
