"""Shared inputs of the state-transition (c4) and results (c5) tests: one
seeded election built by the modules of both packages.

`election(pkg)` makes, with package `pkg` ("davinci_tpu" or
"davinci_tpu_torch") alone, the election of the reference's
scripts/fullsize_c4.py:58-110 at `n_votes`: a key, a state, votes
encrypted and re-encrypted, a LeanIMT census and the 64-level
`prepare_votes_batch`, all drawn from one `random.Random`.  The small
tier of c4 (`SMALL`: 2 votes, the 64-level tree, which the 64-bit vote
ids need, a 4-level census, the blob on a 128-cell domain, which the
two votes' 105 cells need, under lookups) built from it has the
counts, public values and structure hash of `SMALL_REFERENCE`, the
reference's build of it (test_torch_statetransition_ref.py makes it
again).
"""

import functools
import importlib
import random

SEED = 0xC460
PROCESS_ID = 424260
# the lookup tier's challenge and blind of scripts/fullsize_c4.py:173
CHALLENGE, BLIND = 0x1CEB00DAFF40, 7
SMALL = {"n_votes": 2, "n_levels": 64, "census_levels": 4,
         "include_blob": True, "blob_domain_bits": 7, "use_lookup": True}
# the production tier of scripts/fullsize_c4.py (RUN_SLOW_TESTS) and the
# reference's count of it at 2 votes (BENCH_NOTES.md:17)
PRODUCTION = {"n_votes": 2, "n_levels": 64, "census_levels": 20,
              "include_blob": True, "blob_domain_bits": 12,
              "use_lookup": True}
PRODUCTION_CONSTRAINTS = 1563441
SMALL_REFERENCE = {
    "constraints": 701677, "variables": 734483,
    # root_before, root_after, batch hash, census root, z and y in halves
    "public": [
        0xf53a25d4c42c96d7387a85b9bddb89de5ccf79b4e2c18455e4b01793e0746f7,
        0x17c02168ae64196291dd08bcfc51369ba5c166944f7f4d5625f6105bac80ba67,
        0x926fff4bbb8421599c468fed32019a9c615bf4415520f945810c059d8fa001,
        0x1833916f0dafb0b2c91c8a96b90a240687b3c0cb2abe78f5e9c4786b560fb6de,
        0x2303084d27c64ebe658756c1b73cd84,
        0x5af39e4f0f4d617f8f22c811af2ae735,
        0xc17ef9d452f62b9ecee7020555dd9b5f,
        0x1e595fa334efae65aa2ce3118c734416],
    "structure_hash":
        "27add36602d0cba348b6102774a6e1c02b25d5542780fc766e507ebf6e17bbe3"}

# the reference's build of c5 from the same election (`build_c5`), which
# test_torch_results_ref.py makes again: the state root after the batch,
# then the eight decrypted results
C5_REFERENCE = {
    "constraints": 257098, "variables": 252322,
    "public": [
        0x17c02168ae64196291dd08bcfc51369ba5c166944f7f4d5625f6105bac80ba67,
        1, 1, 0, 0, 0, 0, 0, 0],
    "structure_hash":
        "f14e6e1343ba891e49a51dae352f1172ecb0ddb47faeff72ec616456f38b9da8"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@functools.cache
def election(pkg, n_votes=2):
    """(state after the batch, the batch, the public key, the private key,
    the re-encryption randomness, the census root, the census proofs at
    `census_levels` = 20 and 4 (by levels), the inputs hashes, the rng's
    next draw for z) of the seeded election, made by package `pkg`."""
    protocol = _mod(pkg, "spec")
    ballot_mode = _mod(pkg, "ballotmode")
    elgamal = _mod(pkg, "elgamal")
    state = _mod(pkg, "state")
    census = _mod(pkg, "census")

    rng = random.Random(SEED)
    pub, priv = elgamal.generate_key(rng)
    bm = ballot_mode.BallotMode()
    st = state.State(PROCESS_ID)
    st.initialize(1, bm.pack(), (pub.x, pub.y))
    votes, ks = [], []
    for i in range(n_votes):
        choice = [0] * protocol.FIELDS_PER_BALLOT
        choice[i % protocol.FIELDS_PER_BALLOT] = 1
        b = elgamal.Ballot.encrypt(choice, pub, rng.randrange(1, 2**200))
        k_re = rng.randrange(1, 2**200)
        reenc, _ = b.reencrypt(pub, k_re)
        votes.append(state.Vote(
            address=rng.randrange(2**160),
            ballot_index=state.ballot_index_key(i),
            vote_id=protocol.VOTE_ID_MIN + rng.randrange(2**40),
            ballot=b, reencrypted_ballot=reenc, weight=1))
        ks.append(k_re)
    cdb = census.CensusDB()
    cdb.new("c")
    for v in votes:
        cdb.insert("c", v.address, v.weight)
    census_root = cdb.publish("c")
    tree = cdb.by_id["c"].tree
    cproofs = {}
    for levels in (4, 20):
        cproofs[levels] = []
        for i in range(n_votes):
            _, sibs, acts, bits = tree.prove_circuit(i, levels)
            cproofs[levels].append({"kind": "merkle", "siblings": sibs,
                                    "actives": acts, "index_bits": bits,
                                    "index": i})
    batch = st.prepare_votes_batch(votes)
    inputs_hashes = [rng.randrange(1 << 250) for _ in votes]
    return {"state": st, "batch": batch, "pub": pub, "priv": priv,
            "ballot_mode": bm.pack(), "reenc_k": ks,
            "census_root": census_root, "census_proofs": cproofs,
            "inputs_hashes": inputs_hashes,
            "z": random.Random(SEED + 1).randrange(
                _mod(pkg, "fields").BLS12_381_R)}


def blob_cells(batch):
    """The batch's blob cells in `state/blobcodec.pack_batch_blob`'s order
    (scripts/fullsize_c4.py:112-116)."""
    cells = list(batch.new_results.coords()) + [len(batch.votes)]
    for v in batch.votes:
        cells += [v.vote_id, v.address, v.ballot_index, v.weight]
        cells += v.reencrypted_ballot.coords()
    return cells


def c4_inputs(pkg, tier=SMALL):
    """(params, witness) of c4 at `tier` from package `pkg`'s election;
    the blob's y is the host barycentric evaluation at the seeded z."""
    st_mod = _mod(pkg, "circuits.statetransition")
    blob = _mod(pkg, "circuits.blob_gadget")
    e = election(pkg, tier["n_votes"])
    params = st_mod.StateTransitionParams(**tier)
    dom = st_mod._blob_domain(tier["blob_domain_bits"])
    cells = blob_cells(e["batch"])
    y = blob.barycentric_eval_host(
        dom, cells + [0] * (len(dom) - len(cells)), e["z"])
    w = st_mod.StateTransitionWitness(
        batch=e["batch"], process_id=PROCESS_ID,
        ballot_mode_packed=e["ballot_mode"],
        encryption_key=(e["pub"].x, e["pub"].y), census_origin=1,
        reenc_k=e["reenc_k"], inputs_hashes=e["inputs_hashes"],
        census_root=e["census_root"],
        census_proofs=e["census_proofs"][tier["census_levels"]],
        blob_z=e["z"], blob_y=y)
    return params, w


def build_c4(pkg, tier=SMALL, witness=None):
    """c4 at `tier` built by package `pkg` (from `witness`, else its own
    election's) under the fixed challenge and blind; returns (the system,
    params, witness)."""
    st_mod = _mod(pkg, "circuits.statetransition")
    params, w = c4_inputs(pkg, tier)
    w = witness or w
    return (st_mod.build_state_transition_circuit(params, w, CHALLENGE,
                                                  BLIND), params, w)


def fingerprint(cs, pkg):
    """What two builds of one system share: its counts, public values and
    structure hash."""
    ser = _mod(pkg, "groth16.serialize")
    return {"constraints": len(cs.constraints),
            "variables": cs.num_variables, "public": cs.public_values(),
            "structure_hash": ser.cs_structure_hash(cs)}


# The checks of the small tier, collected by the file that imports them
# with a module fixture `c4`: (package, system, params, witness).  A
# tampered value is put back before the check returns.


def _unsat_with(cs, idx, value):
    old = cs.values[idx]
    cs.values[idx] = value % cs.p
    try:
        return not cs.check_satisfied()
    finally:
        cs.values[idx] = old


def test_small_c4_equals_the_recorded_build(c4):
    pkg, cs, _, _ = c4
    assert fingerprint(cs, pkg) == SMALL_REFERENCE


def test_small_c4_is_satisfiable(c4):
    _, cs, _, _ = c4
    assert cs.check_satisfied(), cs.first_unsatisfied()


def test_small_c4_publics_are_the_batch_and_the_blob(c4):
    _, cs, params, w = c4
    half = (1 << 128) - 1
    assert cs.public_values() == [
        w.batch.root_before, w.batch.root_after, w.batch_hash(params),
        w.census_root, w.blob_z & half, w.blob_z >> 128, w.blob_y & half,
        w.blob_y >> 128]


def test_small_c4_root_after_plus_one_is_unsatisfiable(c4):
    _, cs, _, _ = c4
    assert _unsat_with(cs, 2, cs.values[2] + 1)


def test_small_c4_tampered_reencryption_is_unsatisfiable(c4):
    _, cs, _, w = c4
    idx = cs.values.index(w.reenc_k[0], 1)
    assert _unsat_with(cs, idx, cs.values[idx] + 1)


def test_small_c4_tampered_inputs_hash_is_unsatisfiable(c4):
    _, cs, _, w = c4
    idx = cs.values.index(w.inputs_hashes[1], 1)
    assert _unsat_with(cs, idx, cs.values[idx] + 1)


def build_c5(pkg):
    """The results circuit (c5) at full size (64 levels, 8 fields) built by
    package `pkg` from the state its election leaves, decrypted with the
    election's private key; returns (the system, the witness)."""
    results = _mod(pkg, "circuits.results")
    e = election(pkg)
    w = results.results_witness_from_state(e["state"], e["priv"], 100,
                                           random.Random(SEED + 5))
    return results.build_results_circuit(w), w


# The checks of c5, collected by the file that imports them with a module
# fixture `c5`: (package, system, witness).


def test_c5_equals_the_recorded_build(c5):
    pkg, cs, _ = c5
    assert fingerprint(cs, pkg) == C5_REFERENCE


def test_c5_is_satisfiable_and_decrypts_the_votes(c5):
    _, cs, w = c5
    assert w.results == [1, 1, 0, 0, 0, 0, 0, 0]
    assert cs.public_values() == [w.state_root] + w.results
    assert cs.check_satisfied(), cs.first_unsatisfied()


def test_c5_wrong_result_is_unsatisfiable(c5):
    _, cs, _ = c5
    assert _unsat_with(cs, 2, cs.values[2] + 1)


def test_c5_wrong_state_root_is_unsatisfiable(c5):
    _, cs, _ = c5
    assert _unsat_with(cs, 1, cs.values[1] + 1)
