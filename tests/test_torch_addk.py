"""The point-add experiment's port (ec/addk_exp.py, kernel B8) held limb
for limb against the experiment's own kernel bodies on the CPU.

`scripts/addk_exp.py` (loaded from its file, unchanged) defines each
variant's Pallas kernel body, `_kernel_<variant>(consts, x1, ..., z3)`,
on lists of limb rows; called eagerly on jnp (L, n) arrays with numpy
outputs, with no jit and no pallas_call, it is the kernel's own
computation.  The same points (random, edge cases, rescaled near p - 1,
a chained step) go through the port's `add_2d(..., device cpu)`, whose
plain versions the CUDA kernels are held against on the card.  Tolerance
0: integer limbs.  The whole `_add_2d` through pallas_call in interpret
mode runs behind RUN_SLOW_TESTS, as in test_pallas_kernels.py.
"""

import importlib.util
import os
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch.ec import addk_exp as X
from davinci_tpu_torch.ec import cuda_add, get_device_curve

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CANONICAL = ["v2d", "lazy", "kara"]


@pytest.fixture(scope="module")
def exp():
    spec = importlib.util.spec_from_file_location(
        "addk_exp_reference", REPO / "scripts" / "addk_exp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def consts():
    """The experiment's kernel constants, as its run_variant makes them."""
    R = ref_curve(RC.bn254_g1)
    return (tuple(int(x) for x in np.asarray(R.df.p_limbs)),
            tuple(int(x) for x in np.asarray(R.df.nprime_limbs)),
            tuple(int(x) for x in np.asarray(R.b3)))


@pytest.fixture(scope="module")
def dc():
    return get_device_curve(TC.bn254_g1, "cpu")


@pytest.fixture(scope="module")
def cases(dc):
    """(L, m) operands: the experiment's 64 points (seed 0, b rolled by
    7), then the edge cases and the near-p rescalings of 16 of them; and
    the host points of each row."""
    pts, a, b = X.experiment_points(dc, 64)
    A, B = X.hard_cases(dc, pts[:16])
    A = tuple(torch.cat([x, y]) for x, y in zip(a, A))
    B = tuple(torch.cat([x, y]) for x, y in zip(b, B))
    host = (dc.decode_points(A), dc.decode_points(B))
    return (tuple(x.T.contiguous() for x in A),
            tuple(x.T.contiguous() for x in B), host)


def _normalize(limbs):
    """One carry pass over (L, n) limb rows: the same integers in
    canonical 12-bit limbs (the experiment's lazy kernel leaves the limbs
    of its unreduced adds un-rippled where canon subtracts nothing)."""
    out = np.array(limbs, np.int64)
    carry = 0
    for j in range(out.shape[0]):
        v = out[j] + carry
        out[j] = v & 0xFFF
        carry = v >> 12
    assert not np.any(carry)
    return out.astype(np.int32)


def _jax_body(exp, consts, variant, a, b):
    """The experiment's kernel body on jnp (L, n) operands."""
    outs = [np.zeros(tuple(a[0].shape), np.int32) for _ in range(3)]
    getattr(exp, f"_kernel_{variant}")(
        consts, *(jnp.asarray(np.asarray(x)) for x in (*a, *b)), *outs)
    return outs


def _same(variant, jax_out, port_out):
    for j, t in zip(jax_out, port_out):
        if variant == "lazy":
            j = _normalize(j)
        assert np.array_equal(j, t.numpy())


@pytest.fixture(scope="module")
def steps(exp, consts, dc, cases):
    """{variant: (jax outputs, port outputs)} of one add of the cases and,
    behind them in the same batch, a chained step: the port's output fed
    back as the first operand (as the experiment's timing loop feeds its
    own), so one eager call of each kernel body serves both."""
    A, B, _ = cases
    out = {}
    for v in X.KERNELS:
        first = X.add_2d(dc, v, *A, *B)
        chained = X.add_2d(dc, v, *first, *B)
        m = A[0].shape[1]
        jax_out = _jax_body(exp, consts, v,
                            [torch.cat([a, f], 1) for a, f in zip(A, first)],
                            [torch.cat([b, b], 1) for b in B])
        out[v] = ([j[:, :m] for j in jax_out], first,
                  [j[:, m:] for j in jax_out], chained)
    return out


@pytest.mark.parametrize("variant", X.KERNELS)
def test_variant_matches_the_jax_kernel_body(steps, variant):
    jax_out, port_out, _, _ = steps[variant]
    _same(variant, jax_out, port_out)


@pytest.mark.parametrize("variant", X.KERNELS)
def test_chained_step_matches_the_jax_kernel_body(steps, variant):
    _, _, jax_out, port_out = steps[variant]
    _same(variant, jax_out, port_out)


@pytest.mark.parametrize("variant", CANONICAL)
def test_canonical_variants_are_the_complete_add(dc, cases, steps, variant):
    A, B, (hA, hB) = cases
    port_out = steps[variant][1]
    want = cuda_add.rcb15_plain(dc, tuple(x.T for x in A),
                                tuple(x.T for x in B))
    for g, w in zip(port_out, want):
        assert torch.equal(g, w.T)
    got = dc.decode_points(tuple(x.T for x in port_out))
    assert got == [p.add(q) for p, q in zip(hA, hB)]


def test_entry_point_prints_its_lines(capsys):
    assert X.main(["1024", "v2d", "lazy", "kara", "addonly"],
                  device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    for v, line in zip(X.KERNELS, lines):
        assert re.fullmatch(rf"{v}: n=1024  [\d.]+M adds/s  [\d.]+ ms", line)


def test_add_2d_refuses_what_is_not_built(dc):
    bls = get_device_curve(TC.bls381_g1, "cpu")
    P = tuple(x.T.contiguous() for x in bls.identity((4,)))
    with pytest.raises(ValueError, match="BN254"):
        X.add_2d(bls, "v2d", *P, *P)
    Q = tuple(x.T.contiguous() for x in dc.identity((4,)))
    with pytest.raises(ValueError, match="variant"):
        X.add_2d(dc, "strict", *Q, *Q)
    with pytest.raises(ValueError, match="22, n"):
        X.add_2d(dc, "v2d", *(x.T for x in Q), *(x.T for x in Q))
    with pytest.raises(ValueError, match="multiple of 64"):
        X.experiment_points(dc, 100)


def _literals(src, signature):
    """The integer literals of the constant table in addk.cu's function
    `signature`."""
    body = src[src.index(signature):]
    table = re.search(r"\] = \{(.*?)\};", body, re.S).group(1)
    return [int(t, 0) for t in re.findall(r"0x[0-9a-f]+|\d+", table)]


def test_addk_constants_are_bn254():
    """The constants compiled into csrc/addk.cu are BN254's: p, 2p, 3p and
    3b in Montgomery form (R = 2^264) as words, -p^-1 mod 2^32, and p and
    3b as 12-bit limbs."""
    src = (REPO / "davinci_tpu_torch" / "csrc" / "addk.cu").read_text()
    spec = TC.bn254_g1.field_spec
    p = spec.p
    b3 = 3 * TC.bn254_g1.b_ff.v * (1 << 264) % p
    words = lambda x: [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    limbs = lambda x: [(x >> (12 * j)) & 0xFFF for j in range(22)]
    assert _literals(src, "uint32_t kp(int k)") == words(p) + words(2 * p) + words(3 * p)
    assert _literals(src, "void set_b3(F& r)") == words(b3)
    assert _literals(src, "int32_t p_limb(int j)") == limbs(p)
    assert _literals(src, "int32_t b3_limb(int j)") == limbs(b3)
    np0 = int(re.search(r"NP0 = (0x[0-9a-f]+)u", src).group(1), 16)
    assert np0 == -pow(p, -1, 1 << 32) % (1 << 32)


def test_lazy_bounds_fit_the_words():
    """The bounds of csrc/addk.cu's lazy formula, in multiples of p and
    exact: every value below 2^256 (8 words), every product's operands
    below 2^256 - p (its carry-chained accumulator's headroom), every
    product's REDC input below p 2^264, every subtract's K p at or above
    its subtrahend, and the final values below 4p (subtract 2p, then p)."""
    p = TC.bn254_g1.field_spec.p
    words, e = Fraction(2**256, p), Fraction(p, 2**264)
    seen = []

    def val(x):
        assert x < words
        seen.append(x)
        return x

    def mul(a, b):
        assert max(a, b) < words - 1  # a p < 2^256 - p
        assert a * b * p < 2**264  # a b p^2 < p R
        return val(1 + a * b * e)

    def add(a, b):
        return val(a + b)

    def sub(a, b, K):
        assert b <= K
        return val(a + K)

    one = Fraction(1)
    t0, t1, t2 = mul(one, one), mul(one, one), mul(one, one)
    t3 = sub(mul(add(one, one), add(one, one)), add(t0, t1), 3)
    t4 = sub(mul(add(one, one), add(one, one)), add(t1, t2), 3)
    Y3 = sub(mul(add(one, one), add(one, one)), add(t0, t2), 3)
    t0 = add(add(t0, t0), t0)
    t2 = mul(one, t2)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2, 2)
    Y3 = mul(one, Y3)
    X3 = mul(t4, Y3)
    X3 = sub(mul(t3, t1), X3, 2)
    Y3 = add(mul(t1, Z3), mul(Y3, t0))
    Z3 = add(mul(Z3, t4), mul(t0, t3))
    assert max(X3, Y3, Z3) < 4
    assert max(seen) < Fraction(401, 100)  # the comment's 4.01 p


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="interpret-mode kernel runs are slow; set RUN_SLOW_TESTS=1",
)
def test_add_2d_matches_pallas_interpret(exp, consts, dc, monkeypatch):
    """The whole `_add_2d` through pallas_call in interpret mode at
    n = 1,024, every variant, against the port."""
    pl = exp.pl

    class InterpretPallas:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(*args, **kw):
            return pl.pallas_call(*args, interpret=True, **kw)

    monkeypatch.setattr(exp, "pl", InterpretPallas())
    _, a, b = X.experiment_points(dc, 1024)
    at = tuple(x.T.contiguous() for x in a)
    bt = tuple(x.T.contiguous() for x in b)
    for v in X.KERNELS:
        got = exp._add_2d(v, consts,
                          *(jnp.asarray(x.numpy()) for x in (*at, *bt)))
        _same(v, [np.asarray(g) for g in got], X.add_2d(dc, v, *at, *bt))


def test_chip_smoke_names_the_b8_kernels():
    """chip_smoke.py's ptxas summary names each entry function by the
    length-prefixed name inside its mangled symbol (v2d has a digit)."""
    import chip_smoke

    prefix = "_ZN39_GLOBAL__N__92c63b1f_7_addk_cu_930bebcc"
    for v in X.KERNELS:
        name = f"addk_{v}_kernel"
        assert chip_smoke.kernel_name(
            f"{prefix}{len(name)}{name}EPKiS1_S1_S1_S1_S1_PiS2_S2_x") == name
    assert chip_smoke.kernel_name(
        "_ZN41_GLOBAL__N__3de33051_12_point_add_cu_e58ace6b16point_add_"
        "kernelI3Fp2ILi22EEEEvPKiS4_") == "point_add_kernel<Fp2>"
