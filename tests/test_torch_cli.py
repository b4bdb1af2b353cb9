"""The node's entry points (`cli.py`, a verbatim copy) of davinci_tpu_torch
held against the JAX package's on the CPU, each through `cli.main` with
`sys.argv` set, as a user runs `python -m davinci_tpu_torch.cli ...`.

* `e2e --votes 4` on the in-memory chain: the JSON line equals the
  reference's but for `seconds` (the `--rpc-chain` run is in
  tests/test_torch_cli_rpc.py), driven as tests/torch_cli_cases.py says.
* `circuit-compile --export-only` over a store holding one small BN254
  key set up and written by the port (on the CPU): each package's CLI
  writes one `.sol` named by the structure hash, and the texts are equal.

Tolerance: exact equality of JSON values, file names and text.
"""

import torch

from torch_cli_cases import PORT, REF, e2e_matches_reference, mod, run_cli

torch.set_num_threads(1)


def test_e2e_matches_reference(capsys, monkeypatch):
    e2e_matches_reference(["e2e", "--votes", "4"], capsys, monkeypatch)


def _circuit(cs_cls, fr, x=3):
    """x^3 + x + 5 == y over BN254's Fr."""
    y = x**3 + x + 5
    cs = cs_cls(fr)
    yv = cs.pub_input(y)
    xv = cs.priv_input(x)
    cs.assert_eq(cs.mul(cs.mul(xv, xv), xv) + xv + 5, yv)
    return cs


def test_circuit_compile_export_matches_reference(tmp_path, capsys,
                                                  monkeypatch):
    groth16 = mod(PORT, "groth16")
    store = mod(PORT, "circuits.artifacts").ArtifactStore(tmp_path / "store")
    rt = store.load_or_setup(
        "cube-v1", "bn254",
        _circuit(groth16.ConstraintSystem, mod(PORT, "fields").BN254_R),
        g16=groth16.Groth16("bn254", device="cpu"))
    out = {}
    for pkg in (PORT, REF):
        out_dir = tmp_path / pkg
        res = run_cli(pkg, ["circuit-compile", "--artifacts-dir",
                            str(tmp_path / "store"), "--out", str(out_dir),
                            "--export-only"], capsys, monkeypatch)
        out[pkg] = (res, {p.name: p.read_text()
                          for p in sorted(out_dir.glob("*.sol"))})
    assert out[PORT] == out[REF]
    res, sols = out[PORT]
    name = f"cube-v1.{rt.structure_hash[:16]}.sol"
    assert res == {"compiled": [], "exported": [name]}
    assert list(sols) == [name] and "pragma solidity" in sols[name]
