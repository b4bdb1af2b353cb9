"""Shared driver of the CLI tests (tests/test_torch_cli.py and
test_torch_cli_rpc.py): one package's `cli.main` with `sys.argv` set, its
last line of output read as JSON, and the e2e comparison.  In both
packages the finalizer's discrete-log bound is cut to 2^8 (results are at
most the 4 votes; the default, 10^12, is minutes of host search); the
port's Groth16 backends take the CPU (its entry points default to the
card).
"""

import importlib
import json
import sys


REF, PORT = "davinci_tpu", "davinci_tpu_torch"
DL_BOUND = 1 << 8


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run_cli(pkg, argv, capsys, monkeypatch):
    """`pkg`'s `cli.main` with `argv`: its last line of output, as JSON."""
    if pkg == PORT:
        groth16 = mod(PORT, "groth16")
        card = groth16.Groth16

        class OnCPU(card):
            def __init__(self, *a, **kw):
                kw.setdefault("device", "cpu")
                super().__init__(*a, **kw)

        monkeypatch.setattr(groth16, "Groth16", OnCPU)
    seq_pkg = mod(pkg, "sequencer")
    base = seq_pkg.Sequencer

    class Bounded(base):
        def __init__(self, *a, **kw):
            kw.setdefault("max_dl_bound", DL_BOUND)
            super().__init__(*a, **kw)

    monkeypatch.setattr(seq_pkg, "Sequencer", Bounded)
    monkeypatch.setattr(sys, "argv", ["davinci-tpu", *argv])
    capsys.readouterr()
    mod(pkg, "cli").main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def e2e_matches_reference(argv, capsys, monkeypatch):
    got, want = (run_cli(pkg, argv, capsys, monkeypatch)
                 for pkg in (PORT, REF))
    assert got.pop("seconds") >= 0 and want.pop("seconds") >= 0
    assert got == want
    assert got["votes"] == 4 and got["results"][0] + got["results"][1] == 4
    assert got["transitions"] == 1 and got["results_proven"] is False
    return got
