"""Shared inputs of the BW6-761 Groth16 tests: the circuit of
tests/test_bw6.py:39-50 (x^3 + x + 5 = y, y public) and the reference's
key and proof of it, tests/vectors/bw6_groth16.json: `pk_to_bytes`,
`vk_to_bytes` and `proof_to_dict` of the reference's setup from
`random.Random(SETUP_SEED)` and its prove with r = 5, s = 9.
`python tests/torch_bw6_cases.py`, from the repository root, makes them
again; test_torch_bw6_groth16_ref.py holds the reference to them.
"""

import importlib
import json
import random
from pathlib import Path

VECTOR = Path(__file__).parent / "vectors" / "bw6_groth16.json"
SETUP_SEED = 0xB6
R_RAND, S_RAND = 5, 9
X = 3
Y = X**3 + X + 5


def circuit(pkg):
    """x^3 + x + 5 = y over BW6-761's Fr, built by package `pkg`."""
    F = importlib.import_module(f"{pkg}.fields")
    r1cs = importlib.import_module(f"{pkg}.groth16.r1cs")
    cs = r1cs.ConstraintSystem(F.BW6_761_R)
    y = cs.pub_input(Y)
    x = cs.priv_input(X)
    cs.assert_eq(cs.mul(cs.mul(x, x), x) + x + 5, y)
    return cs


def setup_and_prove(g16, pkg):
    """(pk, vk, proof) of `g16` (a Groth16 on BW6-761) for the circuit."""
    pk, vk = g16.setup(circuit(pkg), rng=random.Random(SETUP_SEED))
    return pk, vk, g16.prove(pk, circuit(pkg), r_rand=R_RAND, s_rand=S_RAND)


def to_vector(pkg, g16, pk, vk, proof):
    ser = importlib.import_module(f"{pkg}.groth16.serialize")
    return {"pk": ser.pk_to_bytes(pk, g16.g1, g16.g2).hex(),
            "vk": ser.vk_to_bytes(vk, g16.g1, g16.g2).hex(),
            "proof": ser.proof_to_dict(proof)}


def vector():
    return json.loads(VECTOR.read_text())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    from davinci_tpu.groth16 import Groth16

    g16 = Groth16("bw6_761")
    VECTOR.write_text(json.dumps(
        to_vector("davinci_tpu", g16, *setup_and_prove(g16, "davinci_tpu")),
        indent=1) + "\n")
