"""The real ProverSet: circuits 2-4 wired into the sequencer pipeline.

Role parity: the reference's per-processor prover calls
(sequencer/ballot.go:135 processBallot -> voteVerifier.ProveAndVerify;
aggregate.go:446; statetransition.go:222) through hash-pinned artifact
runtimes (circuits/artifacts.go LoadOrDownload).

Execution tiers per circuit (`mode`):
  * "prove" — full Groth16 through the artifact store (setup cached once);
  * "solve" — build the real circuit and check satisfiability (the gnark
    test.IsSolved / debug-prover tier; marks outputs proven=False,
    solved=True) — used where CI cannot afford device proving;
  * "stub"  — the old development stub.

The CI pipeline test runs circuit 2 in "prove" (lite params), circuits 3-4
in "solve"; the gated TPU tier runs everything in "prove".
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import log
from davinci_tpu_torch.circuits.aggregator import (
    AggregatorParams,
    AggregatorWitness,
    build_aggregator_circuit,
)
from davinci_tpu_torch.circuits.statetransition import (
    StateTransitionParams,
    StateTransitionWitness,
    build_state_transition_circuit,
)
from davinci_tpu_torch.circuits.voteverifier import (
    VoteVerifierParams,
    VoteVerifierWitness,
    build_vote_verifier_circuit,
    witness_vote_hash,
)
from davinci_tpu_torch.groth16.serialize import proof_from_dict, proof_to_dict


@dataclass
class ProverModes:
    vote: str = "prove"
    aggregate: str = "solve"
    state_transition: str = "solve"


class ProtocolProvers:
    """Builds witnesses for circuits 2-4 from pipeline payloads and runs
    them at the configured tier."""

    def __init__(
        self,
        c2_params: VoteVerifierParams,
        store=None,
        modes: ProverModes | None = None,
        n_votes_agg: int = 4,
        c4_overrides: dict | None = None,
        agg_overrides: dict | None = None,
        curves: dict | None = None,
        g16s: dict | None = None,
    ):
        """c4_overrides: extra StateTransitionParams fields (include_blob,
        blob_domain_bits, use_lookup, verify_aggregator, ...);
        agg_overrides: extra AggregatorParams fields (native_r, inner_ctx,
        hash_bytes) for non-default outer curves;
        curves: circuit -> curve-name map, default {"c2": "bls12_377",
        "c3": "bw6_761", "c4": "bn254"} (production 2-chain);
        g16s: curve-name -> prebuilt Groth16 backend, for synthetic curve
        families (the toy 2-chain prove-tier CI, circuits/toycurve.py)."""
        from davinci_tpu_torch.circuits.artifacts import default_store

        self.c2_params = c2_params
        self.store = store or default_store()
        self.modes = modes or ProverModes()
        self.n_votes_agg = n_votes_agg
        self.c4_overrides = c4_overrides or {}
        self.agg_overrides = agg_overrides or {}
        self.curves = {"c2": "bls12_377", "c3": "bw6_761", "c4": "bn254"}
        self.curves.update(curves or {})
        self.g16s = g16s or {}
        self._c2_rt = None
        self._dummy = None  # (proof_dict, vote_hash) canonical padding

    def _load_or_setup(self, circuit_id, circuit_key, cs):
        name = self.curves[circuit_key]
        return self.store.load_or_setup(
            circuit_id, name, cs, g16=self.g16s.get(name)
        )

    # -- circuit 2: per-vote -------------------------------------------------

    def prove_vote(self, item: dict) -> dict:
        """item: pipeline ballot payload with the client material:
        vote_proof_witness = {inputs_hash, ballot_proof(dict)?, sig_r,
        sig_s, priv? / pubkey} (see make_vote_payload)."""
        mode = self.modes.vote
        if mode == "stub":
            return {"kind": "vote", "proven": False}
        w = self._vote_witness(item)
        cs = build_vote_verifier_circuit(self.c2_params, w)
        vote_hash = witness_vote_hash(self.c2_params, w)
        if mode == "solve":
            ok = cs.check_satisfied()
            return {
                "kind": "vote", "proven": False, "solved": bool(ok),
                "vote_hash": hex(vote_hash),
            }
        rt = self._c2_runtime(cs)
        proof = self._c2_prove(rt, w, cs)
        return {
            "kind": "vote",
            "proven": True,
            "vote_hash": hex(vote_hash),
            "proof": proof_to_dict(proof),
        }

    def _c2_prove(self, rt, w, cs):
        """Prove circuit 2: lookup-tier params go through the two-phase
        committed prover (the lookup's Fiat-Shamir gamma is H(D))."""
        if self.c2_params.use_lookup:
            return rt.prove_and_verify_committed(
                lambda challenge, blind: build_vote_verifier_circuit(
                    self.c2_params, w, challenge=challenge, blind=blind
                ),
                cs.public_values(),
            )
        return rt.prove_and_verify(cs)

    def _vote_witness(self, item: dict) -> VoteVerifierWitness:
        wd = item["client"]
        params = self.c2_params
        proof = None
        if params.include_inner_proof:
            proof = proof_from_dict(
                wd["ballot_proof"], params.inner_ctx.g1, params.inner_ctx.g2
            )
        pub = None
        if params.include_signature:
            spec = params.sig_spec
            pub = spec.point(wd["pubkey"][0], wd["pubkey"][1])
        return VoteVerifierWitness(
            process_id=item["pid"],
            address=item["address"],
            vote_id=item["vote_id"],
            inputs_hash=int(wd["inputs_hash"], 16),
            ballot_proof=proof,
            pubkey=pub,
            sig_r=int(wd.get("sig_r", "0x0"), 16),
            sig_s=int(wd.get("sig_s", "0x0"), 16),
        )

    def _c2_runtime(self, cs):
        if self._c2_rt is None:
            self._c2_rt = self._load_or_setup(
                self.c2_params.circuit_id(), "c2", cs
            )
        return self._c2_rt

    def _dummy_vote(self):
        """Canonical dummy vote-verifier proof for aggregator padding
        (reference voteverifier/dummy.go role): a real proof of a fixed
        dummy witness under the same circuit."""
        if self._dummy is None:
            assert self.modes.vote == "prove", "dummy padding needs proving"
            params = self.c2_params
            from davinci_tpu_torch.circuits.voteverifier import (
                make_vote_verifier_witness,
            )

            w = make_vote_verifier_witness(
                params,
                process_id=0,
                priv_sig_key=1,
                inputs_hash=0,
                ballot_proof=None,
                vote_id=1 << 63,
            )
            if not params.include_inner_proof:
                w.ballot_proof = None
            cs = build_vote_verifier_circuit(params, w)
            rt = self._c2_runtime(cs)
            proof = self._c2_prove(rt, w, cs)
            self._dummy = (proof, witness_vote_hash(params, w))
        return self._dummy

    def verify_vote(self, ballot: dict) -> bool:
        """Natively re-verify a stored vote-verifier proof before it
        enters an aggregation batch — fail fast on a bad proof instead of
        discovering it when the whole batch proof fails (reference
        sequencer/aggregate.go:37 verifyVoteVerifierProof)."""
        pr = ballot.get("proof")
        if not ballot.get("proven") or pr is None:
            return True  # solve/stub tiers carry no proof to check
        rt = self._c2_rt
        if rt is None:
            return True
        g16 = rt.g16
        proof = proof_from_dict(pr, g16.g1, g16.g2)
        pub = [int(ballot["vote_hash"], 16)]
        if self.c2_params.use_lookup:
            return g16.verify_committed(rt.vk, proof, pub)
        return g16.verify(rt.vk, proof, pub)

    # -- circuit 3: aggregation ----------------------------------------------

    def prove_aggregate(self, ballots: list) -> dict:
        mode = self.modes.aggregate
        if mode == "stub":
            return {"kind": "aggregate", "count": len(ballots), "proven": False}
        dummy_proof, dummy_hash = self._dummy_vote()
        params = AggregatorParams(
            inner_vk=self._c2_rt.vk,
            dummy_proof=dummy_proof,
            dummy_public=dummy_hash,
            n_votes=self.n_votes_agg,
            inner_committed=self.c2_params.use_lookup,
            **self.agg_overrides,
        )
        hashes, proofs = [], []
        for b in ballots[: self.n_votes_agg]:
            vp = b["vote_proof"]
            assert vp.get("proven"), "aggregating unproven ballots"
            hashes.append(int(vp["vote_hash"], 16))
            proofs.append(
                proof_from_dict(
                    vp["proof"],
                    self._c2_rt.g16.g1,
                    self._c2_rt.g16.g2,
                )
            )
        w = AggregatorWitness(vote_hashes=hashes, proofs=proofs)
        cs = build_aggregator_circuit(params, w)
        from davinci_tpu_torch.circuits.aggregator import batch_hash

        bh = batch_hash(params, w)
        if mode == "solve":
            ok = cs.check_satisfied()
            log.infow("aggregate.solved", count=len(proofs), ok=ok)
            return {
                "kind": "aggregate", "count": len(proofs), "proven": False,
                "solved": bool(ok), "batch_hash": hex(bh),
                "vote_hashes": [hex(h) for h in hashes],
            }
        rt = self._load_or_setup(params.circuit_id(), "c3", cs)
        proof = rt.prove_and_verify(cs)
        return {
            "kind": "aggregate", "count": len(proofs), "proven": True,
            "batch_hash": hex(bh), "proof": proof_to_dict(proof),
            "vote_hashes": [hex(h) for h in hashes],
        }

    # -- circuit 4: state transition -----------------------------------------

    def prove_state_transition(self, batch_summary: dict) -> dict:
        mode = self.modes.state_transition
        if mode == "stub":
            return {"kind": "state_transition", "proven": False}
        w: StateTransitionWitness = batch_summary["witness"]
        params = StateTransitionParams(
            n_votes=batch_summary["n_votes"],
            include_census=w.census_proofs is not None,
            census_levels=batch_summary.get("census_levels", 20),
            **self.c4_overrides,
        )
        cs = build_state_transition_circuit(params, w)
        publics = cs.public_values()
        if mode == "solve":
            ok = cs.check_satisfied()
            log.infow("state_transition.solved", ok=ok)
            return {
                "kind": "state_transition", "proven": False,
                "solved": bool(ok), "public": [hex(x) for x in publics],
            }
        rt = self._load_or_setup(params.circuit_id(), "c4", cs)
        if params.use_lookup:
            proof = rt.prove_and_verify_committed(
                lambda challenge, blind: build_state_transition_circuit(
                    params, w, challenge=challenge, blind=blind
                ),
                publics,
            )
        else:
            proof = rt.prove_and_verify(cs)
        return {
            "kind": "state_transition", "proven": True,
            "public": [hex(x) for x in publics],
            "proof": proof_to_dict(proof),
        }

    def prove_results(self, witness) -> dict:
        # the finalizer path drives the results prover directly
        return {"kind": "results", "proven": False}
