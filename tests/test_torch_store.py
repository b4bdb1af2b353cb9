"""davinci_tpu_torch's `circuits/artifacts.py` (the artifact store) on the
CPU, and a store directory shared with the JAX package's store.

`load_or_setup` sets up once and a fresh store loads from disk with no
setup (tests/test_artifacts.py:57); a changed structure under the same id
raises (:73).  A directory written by the port's store loads in the
reference's with no setup, and the loaded key serializes to the port's
bytes (the other direction: test_torch_store_reference.py).  Every load
asserts that no setup ran: the store catches an unreadable key and sets
up afresh, which would hide a reader that cannot read the other
package's bytes.
"""

import json

import pytest
import torch

from davinci_tpu import fields as RF
from davinci_tpu.circuits.artifacts import ArtifactStore as RefStore
from davinci_tpu.groth16 import ConstraintSystem as RefCS
from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16 import core as ref_core
from davinci_tpu.groth16 import serialize as ref_ser
from davinci_tpu_torch.circuits.artifacts import ArtifactStore
from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16
from davinci_tpu_torch.groth16.serialize import (cs_structure_hash,
                                                 pk_to_bytes, vk_to_bytes)

torch.set_num_threads(1)


def _cubic(CS, x, y):
    cs = CS(RF.BN254_R)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    x3 = cs.mul(cs.mul(xv, xv), xv)
    cs.assert_eq(x3 + xv + 5, yv)
    return cs


def _no_setup(monkeypatch, cls):
    def refuse(*args, **kwargs):
        raise AssertionError("a setup ran where the key should load")

    monkeypatch.setattr(cls, "setup", refuse)


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """A directory written by the port's store: one setup on the CPU."""
    root = tmp_path_factory.mktemp("port-store")
    store = ArtifactStore(root)
    cs = _cubic(ConstraintSystem, 3, 35)
    rt = store.load_or_setup("cubic", "bn254", cs,
                             g16=Groth16("bn254", device="cpu"))
    return dict(root=root, store=store, rt=rt, cs=cs)


def test_load_or_setup_once(port_dir, monkeypatch):
    root, rt = port_dir["root"], port_dir["rt"]
    meta = json.loads((root / "cubic" / "meta.json").read_text())
    assert meta["structure_hash"] == cs_structure_hash(port_dir["cs"])
    assert rt.g16.device == torch.device("cpu")
    _no_setup(monkeypatch, Groth16)
    # a fresh store (a fresh process) loads from disk: the same keys
    cs2 = _cubic(ConstraintSystem, 4, 4**3 + 4 + 5)  # same structure
    rt2 = ArtifactStore(root).load_or_setup("cubic", "bn254", cs2,
                                            g16=Groth16("bn254", device="cpu"))
    assert rt2.vk.alpha_g1 == rt.vk.alpha_g1
    assert rt2.pk.z_g1 == rt.pk.z_g1
    proof = rt2.prove_and_verify(cs2, r_rand=1, s_rand=2)
    assert rt.verify(proof, [4**3 + 4 + 5])
    assert not rt.verify(proof, [35])


def test_structure_hash_pins_circuit(port_dir, monkeypatch):
    _no_setup(monkeypatch, Groth16)
    other = ConstraintSystem(RF.BN254_R)
    y = other.pub_input(9)
    x = other.priv_input(3)
    other.assert_eq(other.mul(x, x), y)
    with pytest.raises(ValueError):
        port_dir["store"].load_or_setup("cubic", "bn254", other)
    assert (cs_structure_hash(_cubic(ConstraintSystem, 3, 35))
            == cs_structure_hash(_cubic(ConstraintSystem, 7, 355)))


def test_port_directory_loads_in_reference_store(port_dir, monkeypatch):
    _no_setup(monkeypatch, ref_core.Groth16)
    ref = RefGroth16("bn254")
    rt = RefStore(port_dir["root"]).load_or_setup("cubic", "bn254",
                                                  _cubic(RefCS, 3, 35), g16=ref)
    port_rt = port_dir["rt"]
    g1, g2 = port_rt.g16.g1, port_rt.g16.g2
    assert (ref_ser.pk_to_bytes(rt.pk, ref.g1, ref.g2)
            == pk_to_bytes(port_rt.pk, g1, g2))
    assert (ref_ser.vk_to_bytes(rt.vk, ref.g1, ref.g2)
            == vk_to_bytes(port_rt.vk, g1, g2))
