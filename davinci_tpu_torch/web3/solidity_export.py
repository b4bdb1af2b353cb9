"""Solidity Groth16 verifier export for BN254 verifying keys.

Role parity: the reference's offline circuit compiler exports a Solidity
verifier contract per on-chain circuit (cmd/circuit-compile/main.go:386
`exportSolidityVerifierFile`, backed by gnark's `vk.ExportSolidity`), and
the contracts repo pins those verifiers for the state-transition and
results proofs.  Here the generator is a small template over our
`VerifyingKey` (groth16/core.py), covering both the plain Groth16
equation and the Pedersen commitment extension (committed-wire D + KEA
proof of knowledge + keccak Fiat-Shamir challenge — the exact host
protocol of `Groth16.commitment_challenge` on bn254).

Only BN254 exports: it is the sole pairing curve with EVM precompiles
(ecAdd 0x06, ecMul 0x07, pairing 0x08), and the only curve whose proofs
the reference posts on-chain (state transition + results, both BN254).

The emitted contract is storage-free and mirrors gnark's layout:
  verifyProof(uint256[8] proof, uint256[N] input)            — plain
  verifyCommittedProof(uint256[12] proof, uint256[N] input)  — with D/PoK
Word order follows web3/encoding.py `groth16_proof_tuple` (G2 coordinates
imaginary-first, the precompile convention).
"""

from __future__ import annotations

BN254_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

_HEADER = """\
// SPDX-License-Identifier: Apache-2.0
// Code generated by davinci-tpu circuit-compile; DO NOT EDIT.
pragma solidity ^0.8.20;

/// @title  Groth16 verifier ({name})
/// @notice Auto-generated from the circuit verifying key.
contract {contract} {{
    // Base and scalar field moduli
    uint256 private constant P = {p};
    uint256 private constant R = {r};

    // Verifying key
    uint256 private constant ALPHA_X = {ax};
    uint256 private constant ALPHA_Y = {ay};
    uint256 private constant BETA_X1 = {bx1};
    uint256 private constant BETA_X0 = {bx0};
    uint256 private constant BETA_Y1 = {by1};
    uint256 private constant BETA_Y0 = {by0};
    uint256 private constant GAMMA_X1 = {gx1};
    uint256 private constant GAMMA_X0 = {gx0};
    uint256 private constant GAMMA_Y1 = {gy1};
    uint256 private constant GAMMA_Y0 = {gy0};
    uint256 private constant DELTA_X1 = {dx1};
    uint256 private constant DELTA_X0 = {dx0};
    uint256 private constant DELTA_Y1 = {dy1};
    uint256 private constant DELTA_Y0 = {dy0};
"""

_K_CONST = """\
    uint256 private constant K{i}_X = {x};
    uint256 private constant K{i}_Y = {y};
"""

_COMMIT_CONSTS = """\
    // Commitment extension (Pedersen D + KEA proof of knowledge)
    uint256 private constant KCHAL_X = {kcx};
    uint256 private constant KCHAL_Y = {kcy};
    uint256 private constant ETA_X1 = {ex1};
    uint256 private constant ETA_X0 = {ex0};
    uint256 private constant ETA_Y1 = {ey1};
    uint256 private constant ETA_Y0 = {ey0};
    bytes17 private constant COMMIT_DST = "davinci-commit-v1";
"""

_BODY = """\

    uint256 private constant N_PUBLIC = {n_pub};

    error InvalidProof();
    error PublicInputNotInField();

    /// G1 addition via precompile 0x06.
    function _g1Add(uint256 ax_, uint256 ay_, uint256 bx_, uint256 by_)
        private view returns (uint256 x, uint256 y)
    {{
        bool ok;
        uint256[4] memory in_ = [ax_, ay_, bx_, by_];
        uint256[2] memory out_;
        assembly {{
            ok := staticcall(gas(), 6, in_, 0x80, out_, 0x40)
        }}
        if (!ok) revert InvalidProof();
        return (out_[0], out_[1]);
    }}

    /// G1 scalar mul via precompile 0x07.
    function _g1Mul(uint256 px, uint256 py, uint256 s)
        private view returns (uint256 x, uint256 y)
    {{
        bool ok;
        uint256[3] memory in_ = [px, py, s];
        uint256[2] memory out_;
        assembly {{
            ok := staticcall(gas(), 7, in_, 0x60, out_, 0x40)
        }}
        if (!ok) revert InvalidProof();
        return (out_[0], out_[1]);
    }}

    /// Public-input linear combination sum_i input_i * K_{{i+1}} + K_0.
    function _publicLC(uint256[N_PUBLIC] calldata input)
        private view returns (uint256 x, uint256 y)
    {{
        x = K0_X;
        y = K0_Y;
        uint256 tx_;
        uint256 ty_;
{lc_body}\
    }}

    /// Core 4-term pairing check e(-A,B)e(alpha,beta)e(PI,gamma)e(C,delta)==1
    /// via precompile 0x08.
    function _pairingCheck(
        uint256[8] calldata proof, uint256 pix, uint256 piy
    ) private view returns (bool) {{
        uint256[24] memory in_;
        // -A, B
        in_[0] = proof[0];
        in_[1] = proof[1] == 0 ? 0 : P - (proof[1] % P);
        in_[2] = proof[2];
        in_[3] = proof[3];
        in_[4] = proof[4];
        in_[5] = proof[5];
        // alpha, beta
        in_[6] = ALPHA_X; in_[7] = ALPHA_Y;
        in_[8] = BETA_X1; in_[9] = BETA_X0; in_[10] = BETA_Y1; in_[11] = BETA_Y0;
        // PI, gamma
        in_[12] = pix; in_[13] = piy;
        in_[14] = GAMMA_X1; in_[15] = GAMMA_X0; in_[16] = GAMMA_Y1; in_[17] = GAMMA_Y0;
        // C, delta
        in_[18] = proof[6]; in_[19] = proof[7];
        in_[20] = DELTA_X1; in_[21] = DELTA_X0; in_[22] = DELTA_Y1; in_[23] = DELTA_Y0;
        uint256[1] memory out_;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 8, in_, 0x300, out_, 0x20)
        }}
        return ok && out_[0] == 1;
    }}

    /// Verify a plain Groth16 proof: [Ax, Ay, Bx1, Bx0, By1, By0, Cx, Cy].
    function verifyProof(
        uint256[8] calldata proof, uint256[N_PUBLIC] calldata input
    ) public view returns (bool) {{
        for (uint256 i = 0; i < N_PUBLIC; i++) {{
            if (input[i] >= R) revert PublicInputNotInField();
        }}
        (uint256 pix, uint256 piy) = _publicLC(input);
        return _pairingCheck(proof[0:8], pix, piy);
    }}
"""

_COMMIT_BODY = """\

    /// KEA check e(PoK, G2) == e(D, [eta]G2), as
    /// e(PoK, -G2) * e(D, eta) == 1 via precompile 0x08.
    function _pokCheck(uint256 dx_, uint256 dy_, uint256 px, uint256 py)
        private view returns (bool)
    {{
        uint256[12] memory in_;
        in_[0] = px; in_[1] = py;
        // -G2 generator
        in_[2] = 11559732032986387107991004021392285783925812861821192530917403151452391805634;
        in_[3] = 10857046999023057135944570762232829481370756359578518086990519993285655852781;
        in_[4] = 17805874995975841540914202342111839520379459829704422454583296818431106115052;
        in_[5] = 13392588948715843804641432497768002650278120570034223513918757245338268106653;
        in_[6] = dx_; in_[7] = dy_;
        in_[8] = ETA_X1; in_[9] = ETA_X0; in_[10] = ETA_Y1; in_[11] = ETA_Y0;
        uint256[1] memory out_;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 8, in_, 0x180, out_, 0x20)
        }}
        return ok && out_[0] == 1;
    }}

    /// Verify a committed proof:
    /// [Ax, Ay, Bx1, Bx0, By1, By0, Cx, Cy, Dx, Dy, PoKx, PoKy].
    function verifyCommittedProof(
        uint256[12] calldata proof, uint256[N_PUBLIC] calldata input
    ) public view returns (bool) {{
        for (uint256 i = 0; i < N_PUBLIC; i++) {{
            if (input[i] >= R) revert PublicInputNotInField();
        }}
        if (!_pokCheck(proof[8], proof[9], proof[10], proof[11])) {{
            return false;
        }}
        (uint256 pix, uint256 piy) = _publicLC(input);
        // Fiat-Shamir challenge keccak(DST || D.x || D.y) mod R, the host
        // protocol of Groth16.commitment_challenge (groth16/core.py)
        uint256 chal = uint256(
            keccak256(abi.encodePacked(COMMIT_DST, proof[8], proof[9]))
        ) % R;
        (uint256 tx_, uint256 ty_) = _g1Mul(KCHAL_X, KCHAL_Y, chal);
        (pix, piy) = _g1Add(pix, piy, tx_, ty_);
        (pix, piy) = _g1Add(pix, piy, proof[8], proof[9]);
        return _pairingCheck(proof[0:8], pix, piy);
    }}
"""


def _g1_words(pt):
    if pt is None or pt.infinity:
        return 0, 0
    return int(pt.x.v), int(pt.y.v)


def _g2_words(pt):
    """-> (x1, x0, y1, y0): imaginary-first per the pairing precompile."""
    x0, x1 = int(pt.x.v[0]), int(pt.x.v[1])
    y0, y1 = int(pt.y.v[0]), int(pt.y.v[1])
    return x1, x0, y1, y0


def export_solidity_verifier(vk, name: str = "circuit") -> str:
    """VerifyingKey (BN254) -> self-contained Solidity verifier source."""
    ax, ay = _g1_words(vk.alpha_g1)
    bx1, bx0, by1, by0 = _g2_words(vk.beta_g2)
    gx1, gx0, gy1, gy0 = _g2_words(vk.gamma_g2)
    dx1, dx0, dy1, dy0 = _g2_words(vk.delta_g2)
    contract = "Verifier" + "".join(
        w.capitalize() for w in name.replace("-", "_").split("_") if w
    )
    src = _HEADER.format(
        name=name, contract=contract, p=BN254_P, r=BN254_R,
        ax=ax, ay=ay, bx1=bx1, bx0=bx0, by1=by1, by0=by0,
        gx1=gx1, gx0=gx0, gy1=gy1, gy0=gy0,
        dx1=dx1, dx0=dx0, dy1=dy1, dy0=dy0,
    )
    for i, pt in enumerate(vk.k_pub_g1):
        x, y = _g1_words(pt)
        src += _K_CONST.format(i=i, x=x, y=y)
    committed = vk.k_challenge_g1 is not None and vk.eta_g2 is not None
    if committed:
        kcx, kcy = _g1_words(vk.k_challenge_g1)
        ex1, ex0, ey1, ey0 = _g2_words(vk.eta_g2)
        src += _COMMIT_CONSTS.format(
            kcx=kcx, kcy=kcy, ex1=ex1, ex0=ex0, ey1=ey1, ey0=ey0
        )
    n_pub = len(vk.k_pub_g1) - 1
    lc_lines = []
    for i in range(n_pub):
        lc_lines.append(
            f"        (tx_, ty_) = _g1Mul(K{i + 1}_X, K{i + 1}_Y, "
            f"input[{i}]);\n"
            f"        (x, y) = _g1Add(x, y, tx_, ty_);\n"
        )
    src += _BODY.format(n_pub=max(n_pub, 1), lc_body="".join(lc_lines))
    if committed:
        src += _COMMIT_BODY
    src += "}\n"
    return src


# ---------------------------------------------------------------------------
# Semantics replay (test harness): re-execute the emitted contract's
# verification protocol from its SOURCE constants using the host pairing —
# the no-EVM-available counterpart of the reference's simulated-geth
# deployment test (circuits/test/statetransition/statetransition_test.go).
# ---------------------------------------------------------------------------


def replay_verifier_source(src: str, proof_words: list, inputs: list) -> bool:
    """Interpret the generated contract's checks in Python.

    proof_words: 8 (plain) or 12 (committed) uint256 words as produced by
    web3/encoding.py groth16_proof_tuple / groth16_commitment_proof_tuple.
    """
    import re

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.pairing import PAIRINGS
    from davinci_tpu_torch.towers import FF

    consts = {
        m.group(1): int(m.group(2))
        for m in re.finditer(
            r"constant (\w+) = (\d+);", src
        )
    }
    n_pub = int(re.search(r"N_PUBLIC = (\d+);", src).group(1))
    ctx = PAIRINGS["bn254"]
    g1, g2 = ctx.g1, ctx.g2

    def g1pt(x, y):
        if x == 0 and y == 0:
            return g1.infinity()
        return C.AffinePoint(g1, g1.fld(x), g1.fld(y))

    def g2pt(x1, x0, y1, y0):
        return C.AffinePoint(g2, FF(g2.fld, (x0, x1)), FF(g2.fld, (y0, y1)))

    r = consts["R"]
    if len(inputs) != n_pub or any(int(x) >= r for x in inputs):
        return False

    beta = g2pt(consts["BETA_X1"], consts["BETA_X0"],
                consts["BETA_Y1"], consts["BETA_Y0"])
    gamma = g2pt(consts["GAMMA_X1"], consts["GAMMA_X0"],
                 consts["GAMMA_Y1"], consts["GAMMA_Y0"])
    delta = g2pt(consts["DELTA_X1"], consts["DELTA_X0"],
                 consts["DELTA_Y1"], consts["DELTA_Y0"])
    alpha = g1pt(consts["ALPHA_X"], consts["ALPHA_Y"])

    pi = g1pt(consts["K0_X"], consts["K0_Y"])
    for i, v in enumerate(inputs):
        k = g1pt(consts[f"K{i + 1}_X"], consts[f"K{i + 1}_Y"])
        pi = pi.add(k.mul(int(v)))

    A = g1pt(proof_words[0], proof_words[1])
    B = g2pt(proof_words[2], proof_words[3], proof_words[4], proof_words[5])
    Cp = g1pt(proof_words[6], proof_words[7])

    if len(proof_words) == 12:
        from davinci_tpu_torch.ethereum import keccak256

        D = g1pt(proof_words[8], proof_words[9])
        pok = g1pt(proof_words[10], proof_words[11])
        eta = g2pt(consts["ETA_X1"], consts["ETA_X0"],
                   consts["ETA_Y1"], consts["ETA_Y0"])
        if not ctx.pairing_check([(pok, g2.gen), (D.neg(), eta)]):
            return False
        data = (
            b"davinci-commit-v1"
            + proof_words[8].to_bytes(32, "big")
            + proof_words[9].to_bytes(32, "big")
        )
        chal = int.from_bytes(keccak256(data), "big") % r
        kch = g1pt(consts["KCHAL_X"], consts["KCHAL_Y"])
        pi = pi.add(kch.mul(chal)).add(D)

    return ctx.pairing_check(
        [(A.neg(), B), (alpha, beta), (pi, gamma), (Cp, delta)]
    )
