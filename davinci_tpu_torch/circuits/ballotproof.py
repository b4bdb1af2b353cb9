"""Ballot-proof circuit (circuit 1): proves a ballot is a correct ElGamal
encryption of field values satisfying the election's ballot-mode rules,
bound to the voter and process through the ballot-inputs hash.

Role parity: the reference's client-side circom circuit
(circuits/ballotproof + vocdoni/davinci-circom).  This framework replaces
the whole client+server proving stack, so the circuit is re-expressed
natively over our frontend (BN254, RTE BabyJubJub) rather than emulating
circom artifacts; the statement proven is the same:

  public:  ballot_inputs_hash
  private: processID, ballot-mode components, encryption key, address,
           master randomness k, field values, ciphertext coordinates
  checks:  * vote-ID derivation voteID = 2^63 + trunc63(Poseidon(pid, addr, k))
           * chained randomness k_i (k_1 = Poseidon(k), k_{i+1} = Poseidon(k_i))
           * per-field encryption C1 = k_i*G, C2 = m_i*G + k_i*PK
           * ballot-mode rules: selected-field ranges [minValue, maxValue],
             cost sum bounds with exponent in {1,2}, optional uniqueness,
             unselected fields encrypt zero
           * inputs-hash binding (spec/ballotinputs.go layout)
"""

from __future__ import annotations

from dataclasses import dataclass

from davinci_tpu_torch import fields as F
from davinci_tpu_torch import spec
from davinci_tpu_torch.ballotmode import BallotMode
from davinci_tpu_torch.circuits import gadgets as G
from davinci_tpu_torch.elgamal import Ballot
from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb
from davinci_tpu_torch.hash import poseidon_hash

VALUE_BITS = 50  # field values and range bounds fit 48 bits (+headroom)
SUM_BITS = 64


@dataclass
class BallotProofWitness:
    process_id: int
    ballot_mode: BallotMode
    pubkey: tuple            # (x, y) RTE
    address: int
    k: int                   # master randomness
    field_values: list[int]
    ballot: Ballot
    weight: int = 1

    @property
    def vote_id(self) -> int:
        return spec.vote_id(self.process_id, self.address, self.k)

    def inputs_hash(self) -> int:
        return spec.ballot_inputs_hash(
            self.process_id,
            self.ballot_mode.pack(),
            self.pubkey[0],
            self.pubkey[1],
            self.address,
            self.vote_id,
            self.ballot.coords(),
            self.weight,
        )


def make_ballot(process_id, bm: BallotMode, pubkey, address, k, values):
    """Client-side helper: encrypt + assemble a witness."""
    from davinci_tpu_torch.elgamal.bjj import BJJ

    ballot = Ballot.encrypt(values, BJJ(*pubkey), k)
    return BallotProofWitness(
        process_id=process_id,
        ballot_mode=bm,
        pubkey=pubkey,
        address=address,
        k=k,
        field_values=list(values),
        ballot=ballot,
    )


def _lt_var(cs: ConstraintSystem, a: LinComb, b: LinComb, nbits: int) -> LinComb:
    """boolean a < b for values known to fit nbits (< 253)."""
    # a < b  iff  (a - b + 2^nbits) has bit nbits == 0... compute via bits of
    # d = a + 2^nbits - b  (in [1, 2^(nbits+1)) ), top bit set iff a >= b
    d = a + cs.constant(1 << nbits) - b
    bits = cs.to_bits(d, nbits + 1)
    return cs.one - bits[nbits]


def build_ballot_proof_circuit(
    w: BallotProofWitness, n_fields: int = spec.FIELDS_PER_BALLOT
) -> ConstraintSystem:
    bm = w.ballot_mode
    bm.validate()
    cs = ConstraintSystem(F.BN254_R)

    # -- public ----------------------------------------------------------
    inputs_hash_pub = cs.pub_input(w.inputs_hash())

    # -- private witness -------------------------------------------------
    pid = cs.priv_input(w.process_id)
    addr = cs.priv_input(w.address)
    k = cs.priv_input(w.k)
    pk = (cs.priv_input(w.pubkey[0]), cs.priv_input(w.pubkey[1]))
    weight = cs.priv_input(w.weight)
    vals = [cs.priv_input(v) for v in w.field_values[:n_fields]]
    coords = [cs.priv_input(c) for c in w.ballot.coords()[: n_fields * 4]]

    # ballot-mode components (public constants of the process, folded in
    # through the packed value inside the inputs hash)
    bm_comp = {
        "num_fields": (cs.priv_input(bm.num_fields), 8, 0),
        "group_size": (cs.priv_input(bm.group_size), 8, 8),
        "unique": (cs.priv_input(int(bm.unique_values)), 1, 16),
        "cost_exp": (cs.priv_input(bm.cost_exponent), 8, 17),
        "max_value": (cs.priv_input(bm.max_value), 48, 25),
        "min_value": (cs.priv_input(bm.min_value), 48, 73),
        "max_sum": (cs.priv_input(bm.max_value_sum), 63, 121),
        "min_sum": (cs.priv_input(bm.min_value_sum), 63, 184),
    }
    packed = cs.constant(0)
    for name, (var, nbits, shift) in bm_comp.items():
        cs.to_bits(var, nbits)  # range-check each component
        packed = packed + var * (1 << shift)

    # -- vote id ----------------------------------------------------------
    h = cs.poseidon([pid, addr, k])
    h_bits = G.to_bits_canonical(cs, h, 254)
    vote_id = cs.constant(spec.VOTE_ID_MIN) + cs.from_bits(h_bits[:63])

    # -- encryption --------------------------------------------------------
    ki = cs.poseidon([k])
    for i in range(n_fields):
        c1 = (coords[4 * i], coords[4 * i + 1])
        c2 = (coords[4 * i + 2], coords[4 * i + 3])
        ki_bits = G.to_bits_canonical(cs, ki, 254)
        kg = G.te_base_mul_bits(cs, ki_bits)
        cs.assert_eq(c1[0], kg[0])
        cs.assert_eq(c1[1], kg[1])
        kpk = G.te_scalar_mul_bits(cs, pk, ki_bits)
        mg = G.te_base_mul(cs, vals[i], nbits=VALUE_BITS)
        rhs = G.te_add(cs, mg, kpk)
        cs.assert_eq(c2[0], rhs[0])
        cs.assert_eq(c2[1], rhs[1])
        if i + 1 < n_fields:
            ki = cs.poseidon([ki])

    # -- ballot-mode rules -------------------------------------------------
    nf = bm_comp["num_fields"][0]
    minv = bm_comp["min_value"][0]
    maxv = bm_comp["max_value"][0]
    sel = []
    for i in range(n_fields):
        # selected_i = [i < num_fields]
        s = _lt_var(cs, cs.constant(i), nf, 8)
        sel.append(s)
        cs.to_bits(vals[i], VALUE_BITS)  # base range check
        # selected: minValue <= v <= maxValue; unselected: v == 0
        ge_min = cs.one - _lt_var(cs, vals[i], minv, VALUE_BITS)
        le_max = cs.one - _lt_var(cs, maxv, vals[i], VALUE_BITS)
        ok = cs.mul(ge_min, le_max)
        cs.assert_eq(cs.mul(s, cs.one - ok), cs.constant(0))
        cs.assert_eq(cs.mul(cs.one - s, vals[i]), cs.constant(0))

    # cost sum with exponent in {1, 2}
    ce = bm_comp["cost_exp"][0]
    is_quadratic = cs.mul(ce - 1, cs.constant(1))  # 0 for e=1, 1 for e=2
    cs.assert_bool(is_quadratic)
    total = cs.constant(0)
    for i in range(n_fields):
        sq = cs.mul(vals[i], vals[i])
        cost = cs.select(is_quadratic, sq, vals[i])
        total = total + cs.mul(sel[i], cost)
    min_sum = bm_comp["min_sum"][0]
    max_sum = bm_comp["max_sum"][0]
    cs.to_bits(total, SUM_BITS * 2)
    ge = cs.one - _lt_var(cs, total, min_sum, SUM_BITS * 2)
    le = cs.one - _lt_var(cs, max_sum, total, SUM_BITS * 2)
    cs.assert_eq(ge, cs.one)
    cs.assert_eq(le, cs.one)

    # uniqueness among selected fields (when the flag is set)
    uniq = bm_comp["unique"][0]
    for i in range(n_fields):
        for j in range(i + 1, n_fields):
            both = cs.mul(sel[i], sel[j])
            eq = cs.is_zero(vals[i] - vals[j])
            cs.assert_eq(
                cs.mul(uniq, cs.mul(both, eq)), cs.constant(0)
            )

    # -- inputs-hash binding ----------------------------------------------
    hash_inputs = [pid, packed, pk[0], pk[1], addr, vote_id] + coords + [weight]
    bound = G.multi_poseidon_gadget(cs, hash_inputs)
    cs.assert_eq(bound, inputs_hash_pub)

    return cs
