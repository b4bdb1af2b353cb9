"""Shared inputs of the BN254 committed-proof tests: the lookup range
circuit of tests/test_lookup.py (each of VALUES below 2^TABLE_BITS
through a 4-entry lookup, one public input 7), and the reference's key
and committed proof of it, tests/vectors/committed_bn254.json
(`pk_to_bytes` of its setup, `proof_to_dict` of `prove_committed` with
random.Random(11), r = 5 and s = 9).  test_torch_committed_ref.py holds
the reference to them, test_torch_committed.py the port;
`python tests/torch_committed_cases.py`, from the repository root, makes
them again.
"""

import importlib
import json
import random
from pathlib import Path

VECTOR = Path(__file__).parent / "vectors" / "committed_bn254.json"
VALUES = (3, 1, 2, 0)
TABLE_BITS = 2


def range_circuit(pkg, challenge, blind):
    """tests/test_lookup.py's circuit, built by package `pkg`."""
    F = importlib.import_module(f"{pkg}.fields")
    r1cs = importlib.import_module(f"{pkg}.groth16.r1cs")
    lookup = importlib.import_module(f"{pkg}.circuits.lookup")
    cs = r1cs.ConstraintSystem(F.BN254_R)
    marker = cs.pub_input(7)
    rc = lookup.LookupRangeChecker(cs, table_bits=TABLE_BITS)
    for v in VALUES:
        rc.range_check(cs.priv_input(v), TABLE_BITS)
    rc.finalize(challenge, blind)
    cs.assert_eq(marker, cs.constant(7))
    return cs


def prove(pkg, g16, pk):
    """`prove_committed` of the circuit by package `pkg`'s `g16`."""
    return g16.prove_committed(
        pk, lambda c, b: range_circuit(pkg, c, b), rng=random.Random(11),
        r_rand=5, s_rand=9)


def reference_vector():
    """The reference's key (its default setup seed) and committed proof."""
    from davinci_tpu.groth16 import Groth16
    from davinci_tpu.groth16.serialize import pk_to_bytes, proof_to_dict

    g16 = Groth16("bn254")
    pk, _ = g16.setup(range_circuit("davinci_tpu", 0, 0))
    return {"pk": pk_to_bytes(pk, g16.g1, g16.g2).hex(),
            "proof": proof_to_dict(prove("davinci_tpu", g16, pk))}


def vector():
    return json.loads(VECTOR.read_text())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    VECTOR.write_text(json.dumps(reference_vector(), indent=1) + "\n")
