"""`pk.bin` written and read a section at a time (`serialize.write_pk`,
`read_pk`) on the CPU: the bytes are the JAX package's `pk_to_bytes`.

Keys are the reference's, of a plain circuit and of a committed one (the
circuits of test_torch_artifacts.py), carried across by `convert.py`.
The port's store writes a key it is handed through `write_pk`, and that
`pk.bin` is the reference's bytes; a second store reads it back through
`read_pk` with no setup.
"""

import pytest
import torch
from test_torch_artifacts import CIRCUITS

from davinci_tpu.groth16 import Groth16 as RefGroth16
from davinci_tpu.groth16 import serialize as ref_ser
from davinci_tpu_torch import convert
from davinci_tpu_torch.circuits.artifacts import ArtifactStore
from davinci_tpu_torch.groth16 import Groth16
from davinci_tpu_torch.groth16 import serialize as ser

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def keys():
    """{name: (the reference's pk bytes, the port's pk and vk)}."""
    ref, port = RefGroth16("bn254"), Groth16("bn254", device="cpu")
    out = {}
    for name, (make_ref, _) in CIRCUITS.items():
        pk, vk = ref.setup(make_ref())
        out[name] = (ref_ser.pk_to_bytes(pk, ref.g1, ref.g2),
                     convert.proving_key_from_reference(pk, port.g1, port.g2),
                     convert.verifying_key_from_reference(vk, port.g1, port.g2))
    return port, out


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_write_pk_gives_the_reference_bytes(keys, name, tmp_path):
    port, got = keys
    want, pk, _ = got[name]
    path = tmp_path / "pk.bin"
    with path.open("wb") as f:
        ser.write_pk(f, pk, port.g1, port.g2)
    assert path.read_bytes() == want
    assert ser.pk_to_bytes(pk, port.g1, port.g2) == want


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_read_pk_reads_the_reference_bytes(keys, name, tmp_path):
    port, got = keys
    want, _, _ = got[name]
    path = tmp_path / "pk.bin"
    path.write_bytes(want)
    with path.open("rb") as f:
        pk = ser.read_pk(f, port.g1, port.g2)
        assert f.read() == b""
    assert ser.pk_to_bytes(pk, port.g1, port.g2) == want


class _Keyed(Groth16):
    """The CPU backend, with a setup that hands back a key already made."""

    def __init__(self, pk, vk):
        super().__init__("bn254", device="cpu")
        self.key = (pk, vk)

    def setup(self, cs, rng=None):
        return self.key


def test_store_streams_the_reference_bytes(keys, tmp_path):
    port, got = keys
    want, pk, vk = got["committed"]
    _, make_port = CIRCUITS["committed"]
    cs = make_port()
    ArtifactStore(tmp_path).load_or_setup("range", "bn254", cs,
                                          g16=_Keyed(pk, vk))
    assert (tmp_path / "range" / "pk.bin").read_bytes() == want

    class NoSetup(_Keyed):
        def setup(self, cs, rng=None):
            raise AssertionError("a setup ran where the key should load")

    rt = ArtifactStore(tmp_path).load_or_setup("range", "bn254", cs,
                                               g16=NoSetup(pk, vk))
    assert ser.pk_to_bytes(rt.pk, port.g1, port.g2) == want
