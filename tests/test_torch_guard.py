"""Guards on davinci_tpu_torch's boundary with the JAX package.

* The host modules it carries over are verbatim copies: each equals its
  reference file once `davinci_tpu` is rewritten to `davinci_tpu_torch`.
  `hash/poseidon.py` keeps the text of its reference's host half and
  runs its device half on torch; the
  KZG trusted setup is the same bytes; `blobs/kzg.py` keeps the text of
  the reference's host functions; `groth16/serialize.py` and
  `circuits/artifacts.py` keep it but for the functions that stream
  `pk.bin`, and `circuits/lookup.py` and `serialize.py` but for the
  committed prove's batched re-solve (`PARTIAL`).
* The node's surface (the API, workers, services, CLI, config, DKG,
  metadata, BLAKE-512) is copied whole; `blobs/cells.py` keeps the
  reference's host functions and runs its batched proofs on torch.
* Importing the package pulls in neither `jax` nor `davinci_tpu`: the
  machine with the GPU has no JAX.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "davinci_tpu", REPO / "davinci_tpu_torch"

VERBATIM = [
    "fields.py", "towers.py", "curves.py", "pairing.py", "log.py",
    "spec.py", "ballotmode.py", "ethereum.py",
    "elgamal/__init__.py", "elgamal/bjj.py", "elgamal/core.py",
    "groth16/r1cs.py",
    "circuits/__init__.py", "circuits/gadgets.py", "circuits/ballotproof.py",
    "circuits/emulated.py",
    "blobs/__init__.py", "blobs/setup.py", "state/blobcodec.py",
    "circuits/algebra.py", "circuits/keccak_gadget.py",
    "circuits/xfield_hash.py", "circuits/ecdsa_gadget.py",
    "circuits/pairing_gadget.py", "circuits/voteverifier.py",
    "circuits/toycurve.py", "circuits/aggregator.py",
    "state/__init__.py", "state/smt.py", "state/state.py", "census.py",
    "circuits/merkle_gadget.py", "circuits/census_gadget.py",
    "circuits/blob_gadget.py", "circuits/statetransition.py",
    "circuits/results.py", "circuits/pairing_gadget6.py",
    "storage/kv.py", "storage/storage.py", "storage/__init__.py",
    "sequencer/pipeline.py", "sequencer/__init__.py",
    "sequencer/provers.py", "csp.py", "statesync.py",
    "web3/encoding.py", "web3/rpc.py", "web3/txmanager.py", "web3/abi.py",
    "web3/blobtx.py", "web3/contracts.py", "web3/fakenode.py",
    "web3/solidity_export.py", "web3/__init__.py",
    "hash/blake512.py", "config.py", "metadata.py", "dkg.py", "workers.py",
    "services.py", "webapp.py", "api.py", "cli.py",
    "hash/__init__.py", "parallel/__init__.py", "msm/__init__.py",
]


def _rewritten(rel):
    return (REF / rel).read_text().replace("davinci_tpu", "davinci_tpu_torch")


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    assert (PORT / rel).read_text() == _rewritten(rel)


def test_trusted_setup_is_the_same_bytes():
    rel = "blobs/kzg_trusted_setup.txt"
    data = (PORT / rel).read_bytes()
    assert len(data) == 807177 and data == (REF / rel).read_bytes()


KZG_HOST = ["Blob", "_domain", "compress_g1", "evaluate_barycentric",
            "verify_kzg_proof", "compute_evaluation_point",
            "split_48b_to_limbs", "versioned_hash"]


def _definitions(path):
    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node)
            for node in ast.parse(text).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("name", KZG_HOST)
def test_kzg_host_functions_keep_the_reference_text(name):
    ref = _definitions(REF / "blobs/kzg.py")[name]
    assert _definitions(PORT / "blobs/kzg.py")[name] == ref.replace(
        "davinci_tpu", "davinci_tpu_torch")


# modules whose functions and methods keep the reference's text but for
# those named: the store writes and reads pk.bin a section at a time
# (`write_pk`, `read_pk`), which the byte functions wrap; the cell proofs'
# batched device path runs on torch; the committed prove's re-solve of
# the challenge's wires inverts in one batch (`batch_inverse`; its values
# are held to the reference's in test_torch_refinalize.py)
PARTIAL = {
    "groth16/serialize.py": {"pk_to_bytes", "pk_from_bytes", "write_pk",
                             "read_pk", "_LoadedRefinalize.__call__"},
    "circuits/lookup.py": {"batch_inverse", "LookupRangeChecker.refinalize"},
    "circuits/artifacts.py": {"ArtifactStore._load_or_setup_disk"},
    "blobs/cells.py": {"compute_cell_proofs_device"},
}


def _members(path):
    """{name: source} of a module's functions and its classes' methods
    ("Class.method")."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = ast.get_source_segment(
                        text, sub)
    return out


@pytest.mark.parametrize("rel", sorted(PARTIAL))
def test_partial_copy_keeps_the_reference_text(rel):
    ref, port = _members(REF / rel), _members(PORT / rel)
    changed = PARTIAL[rel]
    assert set(port) - set(ref) <= changed
    for name, text in ref.items():
        assert name in port, name
        if name not in changed:
            assert port[name] == text.replace("davinci_tpu",
                                              "davinci_tpu_torch"), name


def test_msm_package_names_the_batched_entry_points():
    """The port's `msm/__init__.py` exports what the reference's does,
    the multi-card `sharded_msm` among them."""
    tree = ast.parse((PORT / "msm/__init__.py").read_text())
    names = {alias.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for alias in node.names}
    assert {"msm", "msm_many", "msm_host_input", "sharded_msm"} <= names


def test_poseidon_is_the_host_half_of_its_reference():
    """From the round constants to the iden3 vector checks, the port's
    text is the reference's; after them both go on with the device
    permutation, `DevicePoseidon` and `get_device_poseidon`."""
    ref, port = _rewritten("hash/poseidon.py"), (PORT / "hash/poseidon.py").read_text()
    start = "R_F = 8\n"
    end = 'assert poseidon_hash([1, 2]) == _V2, "Poseidon t=3 does not match iden3 vector"\n'
    host = ref[ref.index(start):ref.index(end) + len(end)]
    assert host.count("\nassert poseidon_hash(") == 2
    assert port[port.index(start):port.index(end) + len(end)] == host
    device = port[port.index(end) + len(end):]
    assert "class DevicePoseidon" in device
    assert "def get_device_poseidon" in device
    assert "import jax" not in port


def test_package_imports_without_jax():
    """A fresh interpreter imports every module of the package and is left
    with no jax and no davinci_tpu module loaded."""
    code = """
import importlib, pkgutil, sys
import davinci_tpu_torch
import davinci_tpu_torch.msm.bucket_kernel
import davinci_tpu_torch.blobs.kzg, davinci_tpu_torch.state.blobcodec
import davinci_tpu_torch.sequencer, davinci_tpu_torch.sequencer.provers
import davinci_tpu_torch.storage, davinci_tpu_torch.statesync
import davinci_tpu_torch.csp, davinci_tpu_torch.web3
import davinci_tpu_torch.web3.contracts, davinci_tpu_torch.web3.fakenode
for m in pkgutil.walk_packages(davinci_tpu_torch.__path__, "davinci_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "davinci_tpu"))
print(len([n for n in sys.modules if n.startswith("davinci_tpu_torch.")]), bad)
assert not bad, bad
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    n_mods = int(out.stdout.split()[0])
    assert n_mods > 25
