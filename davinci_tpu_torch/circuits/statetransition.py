"""State transition (circuit 4, BN254): one proof per batch attesting the
election state tree advanced correctly for up to 60 votes.

Statement (reference circuits/statetransition/statetransition.go:118-144):
  public:  root_before, root_after, batch_hash (the aggregator's public),
           blob_z, blob_y (the EIP-4844 evaluation binding)
  private: the 60 votes (original + re-encrypted ballots, addresses,
           weights, vote ids, re-encryption randomness), the SMT
           transitions, the process-config inclusion proofs, and the
           aggregator proof (BW6-761).
  checks:
    1. process config (id, ballot mode, encryption key, census origin)
       proven under root_before;
    2. the transition chain: root_before -> (ballot write, voteID write)
       per vote -> results write -> root_after, each a MerkleTransition
       (circuits/merkle_gadget.py; reference VerifyRootTransition:336);
    3. per vote: re-encryption correctness — reencrypted = original +
       Enc(0; k) under the process key (VerifyReencryptedVotes:265);
    4. homomorphic tally: new_results = old_results + sum(reencrypted) -
       sum(overwritten)  (VerifyBallots:465);
    5. the per-vote hashes (BN254 Poseidon — NATIVE here, emulated in
       circuit 2) recomputed from the vote data, folded into the keccak
       batch hash that must equal the aggregator's public input;
    6. [verify_aggregator] the BW6-761 aggregator proof verifies
       in-circuit (emulated; VerifyAggregatorProof:240) — heavyweight,
       parameterized off for CI (the binding in 5 still ties the public);
    7. [blob binding] z = keccak-derived evaluation point and y the
       barycentric evaluation of the batch blob (VerifyBlobs:400) — wired
       through circuits/blob_gadget when enabled.

Batch size / tree depth / sub-gadget toggles are compile-time parameters:
production (60 votes, 64 levels, everything on) vs CI-reduced builds run
the identical gadget code.
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch import spec as protocol
from davinci_tpu_torch.circuits import gadgets as G
from davinci_tpu_torch.circuits.keccak_gadget import keccak256_bits
from davinci_tpu_torch.circuits.merkle_gadget import (
    smt_transition_gadget,
    transition_to_gadget_inputs,
)
from davinci_tpu_torch.groth16.r1cs import ConstraintSystem
from davinci_tpu_torch.hash.poseidon import poseidon_hash

VOTE_HASH_BITS = 252


@dataclass
class StateTransitionParams:
    n_votes: int = protocol.VOTES_PER_BATCH
    n_levels: int = 64
    n_fields: int = protocol.FIELDS_PER_BALLOT
    native_r: int = F.BN254_R
    verify_aggregator: bool = False   # emulated BW6 pairing (gated: heavy)
    agg_vk: object = None             # aggregator VerifyingKey when enabled
    agg_ctx: object = None            # aggregator curve ctx (None = BW6-761)
    include_census: bool = True       # census eligibility sub-circuit
    census_levels: int = 20           # max LeanIMT depth (2^20 voters)
    # blob binding (reference VerifyBlobs:400): prove the packed batch blob
    # evaluates to y at z over emulated BLS12-381 Fr.  Production domain is
    # the 4096-cell blob domain; CI uses reduced domains with the same code
    include_blob: bool = False
    blob_domain_bits: int = 12
    # log-derivative lookup range checks (Groth16 commitment extension) for
    # the emulated sub-gadgets; lookup circuits prove via prove_committed
    use_lookup: bool = False
    # batch-hash truncation; MUST match the aggregator's
    # (AggregatorParams.hash_bytes) — the value is circuit 3's public input
    hash_bytes: int = 31
    # per-vote hash truncation; must embed in the aggregator's inner
    # scalar field (252 < BLS12-377 r; toy chains are narrower)
    vote_hash_bits: int = VOTE_HASH_BITS

    def circuit_id(self) -> str:
        cen = f"-c{self.census_levels}" if self.include_census else "-nocen"
        blob = (
            f"-blob{self.blob_domain_bits}" if self.include_blob else ""
        )
        lk = "-lookup" if self.use_lookup else ""
        return (
            f"statetransition-{self.n_votes}v-{self.n_levels}l{cen}{blob}{lk}"
            f"{'-aggv' if self.verify_aggregator else ''}-v1"
        )


@dataclass
class StateTransitionWitness:
    batch: object                 # state.BatchResult
    process_id: int
    ballot_mode_packed: int
    encryption_key: tuple         # (x, y)
    census_origin: int
    reenc_k: list                 # per-vote re-encryption master randomness
    inputs_hashes: list           # per-vote circuit-1 ballot inputs hash
    agg_proof: object = None      # BW6 aggregator proof (when verifying)
    census_root: int = 0          # LeanIMT root / CSP root (public)
    census_proofs: list = None    # per-vote census proof dicts (see below)
    blob_z: int = 0               # KZG evaluation point (public, 2x128b)
    blob_y: int = 0               # claimed blob evaluation (public, 2x128b)
    # census_proofs[i] for a real vote is either
    #   {"kind": "merkle", "siblings": [...], "actives": [...],
    #    "index_bits": [...], "index": int}    (LeanIMT.prove_circuit)
    # or
    #   {"kind": "csp", "public": (x, y), "r8": (x, y), "s": int,
    #    "voter_index": int}                    (csp.generate_proof, TE)

    def vote_hash(self, i: int, hash_p: int,
                  nbits: int = VOTE_HASH_BITS) -> int:
        v = self.batch.votes[i]
        h = poseidon_hash(
            [self.process_id, v.address, v.vote_id, self.inputs_hashes[i]],
            p=hash_p,
        )
        return h & ((1 << nbits) - 1)

    def batch_hash(self, params) -> int:
        from davinci_tpu_torch.ethereum import keccak256

        n = len(self.batch.votes)
        data = bytes([n])
        for i in range(params.n_votes):
            if i < n:
                data += self.vote_hash(
                    i, params.native_r, params.vote_hash_bits
                ).to_bytes(32, "big")
            else:
                data += (0).to_bytes(32, "big")
        return int.from_bytes(keccak256(data)[: params.hash_bytes], "big")


def build_state_transition_circuit(
    params: StateTransitionParams, w: StateTransitionWitness,
    challenge: int = 0, blind: int = 0,
) -> ConstraintSystem:
    """challenge/blind: two-phase commitment inputs when params.use_lookup
    (driven by Groth16.prove_committed)."""
    cs = ConstraintSystem(params.native_r)
    rc = None
    if params.use_lookup:
        from davinci_tpu_torch.circuits.lookup import LookupRangeChecker

        rc = LookupRangeChecker(cs, table_bits=12)
    batch = w.batch
    n = params.n_votes
    nv = len(batch.votes)
    assert nv <= n

    # -- public inputs ------------------------------------------------------
    root_before = cs.pub_input(batch.root_before)
    root_after = cs.pub_input(batch.root_after)
    batch_hash_pub = cs.pub_input(w.batch_hash(params))
    census_root = (
        cs.pub_input(w.census_root) if params.include_census else None
    )
    blob_pubs = None
    if params.include_blob:
        # z/y are BLS12-381 Fr values (exceed the native field): 2x128-bit
        # public halves (reference statetransition.go BlobEvalZ/Y layout)
        blob_pubs = [
            cs.pub_input(v)
            for v in (
                w.blob_z & ((1 << 128) - 1), w.blob_z >> 128,
                w.blob_y & ((1 << 128) - 1), w.blob_y >> 128,
            )
        ]

    # -- process config under root_before -----------------------------------
    pid = cs.priv_input(w.process_id)
    bm = cs.priv_input(w.ballot_mode_packed)
    ek = (cs.priv_input(w.encryption_key[0]), cs.priv_input(w.encryption_key[1]))
    corig = cs.priv_input(w.census_origin)
    with cs.scope("process-config"):
        _assert_inclusion(
            cs, params, root_before, batch.process_proofs["id"],
            protocol.STATE_KEY_PROCESS_ID, [pid],
        )
        _assert_inclusion(
            cs, params, root_before, batch.process_proofs["ballot_mode"],
            protocol.STATE_KEY_BALLOT_MODE, [bm],
        )
        _assert_inclusion(
            cs, params, root_before, batch.process_proofs["encryption_key"],
            protocol.STATE_KEY_ENCRYPTION_KEY, [ek[0], ek[1]],
        )
        _assert_inclusion(
            cs, params, root_before, batch.process_proofs["census_origin"],
            protocol.STATE_KEY_CENSUS_ORIGIN, [corig],
        )

    # census origin switch (reference VerifyIsValidCensusOrigin + the
    # census/gnark.go predicates); exactly one family must hold
    if params.include_census:
        from davinci_tpu_torch.circuits.census_gadget import (
            csp_eddsa_verify,
            is_csp_origin,
            is_merkle_origin,
            leanimt_verify,
            pack_census_leaf_gadget,
        )

        is_mk = is_merkle_origin(cs, corig)
        is_csp = is_csp_origin(cs, corig)
        cs.assert_eq(is_mk + is_csp, cs.one)

    # -- transition chain ----------------------------------------------------
    roots = [root_before]

    def apply_transition(t, label):
        with cs.scope(label):
            old_r = roots[-1]
            new_r = cs.priv_input(t.new_root)
            inputs = transition_to_gadget_inputs(cs, t, params.n_levels)
            smt_transition_gadget(
                cs, params.n_levels, old_r, new_r, **inputs
            )
            roots.append(new_r)
            return inputs

    vote_hash_bits_all = []
    blob_vote_cells = []
    reenc_sum = None
    over_sum = None
    mask = []
    for i in range(n):
        real = i < nv
        v = batch.votes[i] if real else None
        m = cs.priv_input(1 if real else 0)
        cs.assert_bool(m)
        mask.append(m)
        if i > 0:
            # latch: real votes form a prefix
            cs.assert_eq(cs.mul(m, cs.one - mask[i - 1]), cs.constant(0))

        bt = batch.ballot_transitions[i]
        vt = batch.voteid_transitions[i]
        b_inputs = apply_transition(bt, f"ballot-{i}")
        v_inputs = apply_transition(vt, f"voteid-{i}")
        # masked slots are noops; real slots are real writes
        for tri in (b_inputs, v_inputs):
            enabled_t = tri["fnc0"] + tri["fnc1"]
            cs.assert_eq(cs.mul(cs.one - m, enabled_t), cs.constant(0))
            cs.assert_eq(cs.mul(m, cs.one - enabled_t), cs.constant(0))

        with cs.scope(f"vote-{i}"):
            if real:
                orig = [cs.priv_input(c) for c in v.ballot.coords()]
                reenc = [
                    cs.priv_input(c) for c in v.reencrypted_ballot.coords()
                ]
                over = [
                    cs.priv_input(c) for c in v.overwritten_ballot.coords()
                ]
                addr = cs.priv_input(v.address)
                weight = cs.priv_input(v.weight)
                vid = cs.priv_input(v.vote_id)
                bidx = cs.priv_input(v.ballot_index)
                ih = cs.priv_input(w.inputs_hashes[i])
                k_master = cs.priv_input(w.reenc_k[i])
            else:
                zero_coords = [cs.constant(0)] * (params.n_fields * 4)
                orig = reenc = over = zero_coords
                addr = weight = vid = ih = cs.constant(0)
                bidx = cs.constant(0)
                k_master = cs.constant(0)

            if real:
                # 3. re-encryption: reenc_j = orig_j + Enc(0; k_j), chained
                # randomness k_1 = Poseidon(k), k_{j+1} = Poseidon(k_j)
                # (mirrors elgamal Ballot.reencrypt semantics)
                kj = cs.poseidon([k_master])
                for j in range(params.n_fields):
                    kb = G.to_bits_canonical(cs, kj, 254)
                    kg = G.te_base_mul_bits(cs, kb)
                    kpk = G.te_scalar_mul_bits(cs, ek, kb)
                    c1o = (orig[4 * j], orig[4 * j + 1])
                    c2o = (orig[4 * j + 2], orig[4 * j + 3])
                    c1n = G.te_add(cs, c1o, kg)
                    c2n = G.te_add(cs, c2o, kpk)
                    cs.assert_eq(c1n[0], reenc[4 * j])
                    cs.assert_eq(c1n[1], reenc[4 * j + 1])
                    cs.assert_eq(c2n[0], reenc[4 * j + 2])
                    cs.assert_eq(c2n[1], reenc[4 * j + 3])
                    if j + 1 < params.n_fields:
                        kj = cs.poseidon([kj])

                # ballot-leaf binding: the written leaf value commits the
                # re-encrypted ballot + address + weight
                leaf_val = G.multi_poseidon_gadget(
                    cs, reenc + [addr, weight]
                )
                cs.assert_eq(leaf_val, b_inputs["value"])
                # overwritten binding: an UPDATE overwrites this voter's
                # previous leaf (a collision-INSERT's old_value is some
                # other key's leaf — not an overwrite)
                old_leaf_val = G.multi_poseidon_gadget(
                    cs, over + [addr, weight]
                )
                cs.assert_eq(
                    cs.mul(
                        b_inputs["fnc1"], old_leaf_val - b_inputs["old_value"]
                    ),
                    cs.constant(0),
                )
                # fresh voters (insert) must claim a zero overwritten ballot
                zero_b = _is_zero_ballot(cs, over)
                cs.assert_eq(
                    cs.mul(b_inputs["fnc0"], cs.one - zero_b),
                    cs.constant(0),
                )

            # 4. tally accumulation (masked TE point sums)
            reenc_sum = _acc_ballot(cs, params, reenc_sum, reenc, m)
            over_sum = _acc_ballot(cs, params, over_sum, over, m)

            # ballot write key binding: key == ballot_index (reference
            # VerifyMerkleTransitionKeys: Ballot[i].VerifyNewKey)
            bkey = cs.from_bits(b_inputs["key_bits"])
            cs.assert_eq(cs.mul(m, bkey - bidx), cs.constant(0))

            # voteID write binding: key == voteID, fixed leaf value
            vkey = cs.from_bits(v_inputs["key_bits"])
            cs.assert_eq(cs.mul(m, vkey - vid), cs.constant(0))
            cs.assert_eq(
                cs.mul(
                    m,
                    v_inputs["value"]
                    - cs.constant(protocol.VOTE_ID_LEAF_VALUE),
                ),
                cs.constant(0),
            )

            # 5. per-vote hash (native Poseidon over BN254)
            vh = cs.poseidon([pid, addr, vid, ih])
            vh_bits = G.to_bits_canonical(cs, vh, 254)[: params.vote_hash_bits]
            vote_hash_bits_all.append([cs.mul(m, b) for b in vh_bits])

            # the slot's blob cells in codec order (state/blobcodec
            # pack_batch_blob); padded slots carry structural zeros —
            # exactly the blob's zero padding
            blob_vote_cells.append([vid, addr, bidx, weight] + list(reenc))

        # 6. census eligibility (VerifyMerkleCensusProofs:495 /
        # VerifyCSPCensusProofs:517) — both gadgets run uniformly, the
        # final equalities masked by (real AND matching-origin)
        if params.include_census:
            with cs.scope(f"census-{i}"):
                L = params.census_levels
                cp = (
                    w.census_proofs[i]
                    if real and w.census_proofs is not None
                    else None
                )
                mk = cp if cp and cp["kind"] == "merkle" else None
                sibs = [
                    cs.priv_input(x)
                    for x in (mk["siblings"] if mk else [0] * L)
                ]
                acts = [
                    cs.priv_input(x)
                    for x in (mk["actives"] if mk else [0] * L)
                ]
                bits = [
                    cs.priv_input(x)
                    for x in (mk["index_bits"] if mk else [0] * L)
                ]
                for b in bits:
                    cs.assert_bool(b)
                en_mk = cs.mul(m, is_mk)
                leaf = pack_census_leaf_gadget(cs, addr, weight)
                leanimt_verify(cs, census_root, leaf, bits, sibs, acts, en_mk)
                idx_val = cs.from_bits(bits)
                cs.assert_eq(
                    cs.mul(
                        en_mk,
                        bidx - (idx_val + cs.constant(protocol.BALLOT_MIN)),
                    ),
                    cs.constant(0),
                )

                cpp = cp if cp and cp["kind"] == "csp" else None
                pub = (
                    cs.priv_input(cpp["public"][0] if cpp else 0),
                    cs.priv_input(cpp["public"][1] if cpp else 1),
                )
                r8 = (
                    cs.priv_input(cpp["r8"][0] if cpp else 0),
                    cs.priv_input(cpp["r8"][1] if cpp else 1),
                )
                s_val = cs.priv_input(cpp["s"] if cpp else 0)
                vidx = cs.priv_input(cpp["voter_index"] if cpp else 0)
                vb = G.to_bits_canonical(
                    cs, vidx, protocol.VOTER_INDEX_MAX.bit_length()
                )
                G.assert_bits_lt_const(cs, vb, protocol.VOTER_INDEX_MAX + 1)
                en_csp = cs.mul(m, is_csp)
                msg = cs.poseidon([vidx, pid, addr, weight])
                csp_eddsa_verify(cs, census_root, msg, pub, r8, s_val, en_csp)
                cs.assert_eq(
                    cs.mul(
                        en_csp,
                        bidx - (vidx + cs.constant(protocol.BALLOT_MIN)),
                    ),
                    cs.constant(0),
                )

    # results transition + tally equality
    rt = batch.results_transition
    r_inputs = apply_transition(rt, "results")
    cs.assert_eq(roots[-1], root_after)
    with cs.scope("tally"):
        old_res = [cs.priv_input(c) for c in batch.old_results.coords()]
        new_res = [cs.priv_input(c) for c in batch.new_results.coords()]
        old_val = G.multi_poseidon_gadget(cs, old_res)
        new_val = G.multi_poseidon_gadget(cs, new_res)
        cs.assert_eq(old_val, r_inputs["old_value"])
        cs.assert_eq(new_val, r_inputs["value"])
        # new = old + reenc_sum - over_sum, per ciphertext point
        for j in range(params.n_fields):
            for pt in range(2):  # c1, c2
                o = (
                    old_res[4 * j + 2 * pt],
                    old_res[4 * j + 2 * pt + 1],
                )
                a = G.te_add(
                    cs,
                    o,
                    (
                        reenc_sum[4 * j + 2 * pt],
                        reenc_sum[4 * j + 2 * pt + 1],
                    ),
                )
                ns = G.te_add(
                    cs,
                    a,
                    _te_neg(
                        cs,
                        (
                            over_sum[4 * j + 2 * pt],
                            over_sum[4 * j + 2 * pt + 1],
                        ),
                    ),
                )
                cs.assert_eq(ns[0], new_res[4 * j + 2 * pt])
                cs.assert_eq(ns[1], new_res[4 * j + 2 * pt + 1])

    # -- batch hash binding (the aggregator's public input) ------------------
    with cs.scope("batch-hash"):
        count = cs.constant(0)
        for m in mask:
            count = count + m
        count_bits = cs.to_bits(count, 8)
        msg = _value_bits_to_bytes(cs, count_bits, 1)
        for bits in vote_hash_bits_all:
            msg += _value_bits_to_bytes(cs, bits, 32)
        digest = keccak256_bits(cs, msg)
        bound = _bytes_bits_to_value(cs, digest[: params.hash_bytes * 8])
        cs.assert_eq(bound, batch_hash_pub)

    # -- blob binding (reference VerifyBlobs:400) ----------------------------
    if params.include_blob:
        with cs.scope("blob"):
            from davinci_tpu_torch.circuits.blob_gadget import blob_eval
            from davinci_tpu_torch.circuits.emulated import EmulatedOps

            E = EmulatedOps(cs, F.BLS12_381_R, range_checker=rc)
            dom = _blob_domain(params.blob_domain_bits)

            def _from_halves(lo, hi):
                for h in (lo, hi):
                    if rc is not None:
                        rc.range_check(h, 128)
                    else:
                        cs.to_bits(h, 128)
                return E.add(
                    E.bind_native(lo), E.cmul(E.bind_native(hi), 1 << 128)
                )

            z_var = _from_halves(blob_pubs[0], blob_pubs[1])
            y_var = _from_halves(blob_pubs[2], blob_pubs[3])
            cells = [E.bind_native(v) for v in new_res]
            cells.append(E.bind_native(count))
            for slot in blob_vote_cells:
                cells.extend(E.bind_native(v) for v in slot)
            assert len(cells) <= len(dom), "blob overflow"
            cells += [E.zero] * (len(dom) - len(cells))
            blob_eval(cs, E, dom, cells, z_var, y_var)

    # -- aggregator proof (emulated BW6-761) ---------------------------------
    if params.verify_aggregator:
        with cs.scope("aggregator-proof"):
            from davinci_tpu_torch.circuits.pairing_gadget6 import (
                Groth16VerifierGadgetBW6,
            )

            gadget = Groth16VerifierGadgetBW6(
                cs, params.agg_vk, ctx=params.agg_ctx, range_checker=rc
            )
            pv = gadget.alloc_proof(w.agg_proof)
            # the aggregator's single public input IS our batch hash
            bh_bits = cs.to_bits(batch_hash_pub, params.hash_bytes * 8)
            gadget.assert_valid(pv, [bh_bits])

    if rc is not None:
        rc.finalize(challenge, blind)
        cs._refinalize = rc.refinalize
    return cs


def _blob_domain(bits: int) -> list:
    """brp-ordered 2^bits evaluation domain, EIP-4844 PRIMITIVE_ROOT=7
    convention.  bits=12 IS the production blob domain (kzg._domain);
    reduced sizes run the identical gadget code in CI."""
    if bits == 12:
        from davinci_tpu_torch.blobs.kzg import _domain

        return _domain()
    from davinci_tpu_torch.blobs.setup import _brp

    R = F.BLS12_381_R
    n = 1 << bits
    wroot = pow(7, (R - 1) // n, R)
    roots = []
    cur = 1
    for _ in range(n):
        roots.append(cur)
        cur = cur * wroot % R
    return [roots[_brp(i, bits)] for i in range(n)]


# -- helpers -----------------------------------------------------------------


def _assert_inclusion(cs, params, root, proof, key: int, values: list):
    """Bind a config leaf under `root` via the inclusion gadget."""
    leaf_v = (
        values[0]
        if len(values) == 1
        else G.smt_encode_leaf_value(cs, values)
    )
    kk = cs.constant(key)
    lh = G.smt_leaf_hash(cs, kk, leaf_v)
    G.smt_verify_inclusion(
        cs,
        root,
        [cs.priv_input(x) for x in proof.padded_siblings(params.n_levels)],
        kk,
        lh,
        params.n_levels,
    )


def _acc_ballot(cs, params, acc, coords, m):
    """Masked accumulation of a ballot's TE points into the running sum."""
    if acc is None:
        return [cs.mul(m, c) for c in coords]
    out = []
    for j in range(params.n_fields * 2):
        pt = (coords[2 * j], coords[2 * j + 1])
        cur = (acc[2 * j], acc[2 * j + 1])
        added = G.te_add(cs, cur, pt)
        out.append(cs.select(m, added[0], cur[0]))
        out.append(cs.select(m, added[1], cur[1]))
    return out


def _te_neg(cs, pt):
    """BabyJubJub (RTE) negation: (x, y) -> (-x, y)."""
    return (-pt[0], pt[1])


def _is_zero_ballot(cs, coords):
    """Boolean: all ciphertexts are the identity (0, 1) pairs."""
    acc = cs.one
    for j in range(0, len(coords), 2):
        zx = cs.is_zero(coords[j])
        oy = cs.is_zero(coords[j + 1] - cs.one)
        acc = cs.mul(acc, cs.mul(zx, oy))
    return acc


def _value_bits_to_bytes(cs, bits, nbytes: int):
    zero = cs.constant(0)
    padded = (list(bits) + [zero] * (nbytes * 8))[: nbytes * 8]
    out = []
    for j in range(nbytes):
        out.extend(padded[8 * (nbytes - 1 - j) : 8 * (nbytes - j)])
    return out


def _bytes_bits_to_value(cs, msg_bits):
    nbytes = len(msg_bits) // 8
    acc = cs.constant(0)
    wgt = 0
    for j in reversed(range(nbytes)):
        for i in range(8):
            acc = acc + cs.coerce(msg_bits[8 * j + i]) * (1 << wgt)
            wgt += 1
    return acc
