"""The port's launch paths on the CPU: B1's entry for limb-major planes
(`cuda_add.point_add_planes`, the scan path's adds), the scan path's
window combine on B5 (`pippenger._reduce_combine_t`), B6's direct path
for contiguous rows (`cuda_mul.direct_rows`) and the NTT's cached power
tables.  On CPU tensors every kernel wrapper runs its plain version, so
these tests pin what the kernels are handed and what they must return.
Inputs come from seeded host randomness; the reference's add runs on its
CPU branch.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from davinci_tpu import curves as RC
from davinci_tpu.ec import get_device_curve as ref_curve
from davinci_tpu.msm import pippenger as rpp
from davinci_tpu_torch import curves as TC
from davinci_tpu_torch import fields as TF
from davinci_tpu_torch.ec import cuda_add, get_device_curve
from davinci_tpu_torch.ff import cuda_mul, get_device_field
from davinci_tpu_torch.msm import bucket_kernel as bk
from davinci_tpu_torch.msm import pippenger as pp
from davinci_tpu_torch.ntt.ntt import DeviceNTT

torch.set_num_threads(1)

CURVES = ["bn254_g1", "bls381_g1"]


def _projective(dc, n, seed):
    """n random points with Z != 1, (n, L) x3, from 8 host points."""
    r = random.Random(seed)
    spec = dc.spec
    base = dc.encode_points([spec.gen.mul(r.randrange(1, spec.r))
                             for _ in range(8)])
    i = torch.tensor([r.randrange(8) for _ in range(2 * n)])
    return cuda_add.rcb15_plain(dc, tuple(a[i[:n]] for a in base),
                                tuple(a[i[n:]] for a in base))


def _planes(p, shape):
    """(N, L) x3 -> (L, *shape) x3 limb-major planes."""
    return tuple(a.T.reshape((a.shape[-1],) + shape).contiguous() for a in p)


@pytest.mark.parametrize("name", CURVES)
def test_planes_entry_matches_rows_and_reference(name):
    """(L, 2, 5) planes: the planes entry equals the row route (rows in,
    rows out) and the reference's `_t_add`; edge cases included (O + P,
    P + O, P + P, P + (-P))."""
    dc = get_device_curve(getattr(TC, name), "cpu")
    P = _projective(dc, 10, 1)
    Q = tuple(torch.roll(a, 3, 0) for a in P)
    ident = dc.identity((1,))
    for c in range(3):  # O + P, P + O, P + P, P + (-P) in the first lanes
        P[c][0], Q[c][1], Q[c][2] = ident[c][0], ident[c][0], P[c][2]
    Q[1][3] = dc.neg(tuple(a[3:4] for a in P))[1][0]
    Q[0][3], Q[2][3] = P[0][3], P[2][3]
    p, q = _planes(P, (2, 5)), _planes(Q, (2, 5))
    got = cuda_add.point_add_planes(dc, p, q)
    rows = dc.add(P, Q)
    for g, w in zip(got, _planes(rows, (2, 5))):
        assert g.is_contiguous() and torch.equal(g, w)
    R = ref_curve(getattr(RC, name))
    want = rpp._t_add(R, tuple(jnp.asarray(a.numpy()) for a in p),
                      tuple(jnp.asarray(a.numpy()) for a in q))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert [pt.infinity for pt in dc.decode_points(rows)[:4]] == [
        False, False, False, True]


def test_planes_entry_refuses_mismatched_planes():
    dc = get_device_curve(TC.bn254_g1, "cpu")
    p = _planes(_projective(dc, 4, 2), (4,))
    with pytest.raises(ValueError):
        cuda_add.point_add_planes(dc, p, tuple(a[:, :3] for a in p))
    with pytest.raises(ValueError):  # rows are not planes
        cuda_add.point_add_planes(dc, tuple(a.T for a in p),
                                  tuple(a.T for a in p))


def _combine_by_doublings(dc, A, B, shifted):
    """The combine as point adds: B4 over [A | B], log2(C) doublings of
    sum_c B_c, + sum_c c A_c, + sum_c A_c when shifted."""
    L, Wt, Cw = A[0].shape
    prep = lambda t: torch.cat(t, dim=0).permute(2, 0, 1)
    s = torch.cat([prep(A), prep(B)], dim=2).contiguous()
    A2, B2 = bk.suffix_reduce_kernel(dc, s)
    part = lambda X, lo, hi: tuple(X[c * L:(c + 1) * L, lo:hi]
                                   for c in range(3))
    CB = part(A2, Wt, 2 * Wt)
    for _ in range(Cw.bit_length() - 1):
        CB = pp._t_double(dc, CB)
    out = pp._t_add(dc, CB, part(B2, 0, Wt))
    if shifted:
        out = pp._t_add(dc, out, part(A2, 0, Wt))
    return out


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("name", CURVES)
def test_combine_on_b5_matches_doubling_chain(name, shifted):
    """Wt 3, C 8: B5's Horner step of two windows gives the limbs of the
    nine-add chain (three doublings, one add), and the host's
    C sum_c B_c + sum_c c A_c (+ sum_c A_c)."""
    dc = get_device_curve(getattr(TC, name), "cpu")
    Wt, Cw = 3, 8
    pa = _projective(dc, Wt * Cw, 3)
    pb = _projective(dc, Wt * Cw, 4)
    A, B = _planes(pa, (Wt, Cw)), _planes(pb, (Wt, Cw))
    got = pp._reduce_combine_t(dc, A, B, shifted)
    want = _combine_by_doublings(dc, A, B, shifted)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ha, hb = dc.decode_points(pa), dc.decode_points(pb)
    for w, pt in enumerate(dc.decode_points(tuple(a.T for a in got))):
        host = dc.spec.infinity()
        for c in range(Cw):
            k = w * Cw + c
            host = host.add(hb[k].mul(Cw)).add(ha[k].mul(c + shifted))
        assert pt == host


def _rows(df, n, seed):
    r = random.Random(seed)
    return df.encode([r.randrange(df.spec.p) for _ in range(n)])


@pytest.mark.parametrize("case", ["stage", "scalar", "row", "row_first",
                                  "one", "offset_view"])
def test_direct_rows_match_plain(case):
    """The operand pairs the NTT hands B6 (a twiddle product, the scale by
    n^-1 as an (L,) row, a broadcast (1, L) row on either side, a view at
    an odd row offset) go to the kernel as they are; element i of the
    kernel's plan, row i % na of a times row i % nb of b, equals the
    plain product."""
    df = get_device_field(TF.bn254_fr, "cpu")
    n = 32
    a, b = _rows(df, n + 1, 5), _rows(df, n, 6)
    x, y = {"stage": (a[:n], b), "scalar": (a[:n], b[0]),
            "row": (a[:n], b[:1]), "row_first": (b[:1], a[:n]),
            "one": (a[0], b[0]), "offset_view": (a[1:], b)}[case]
    plan = cuda_mul.direct_rows(x, y, df.L)
    assert plan is not None
    na, nb, m, shape = plan
    i = torch.arange(m)
    rows = lambda t, k: t.reshape(-1, df.L)[i % k]
    got = cuda_mul.mont_mul_plain(df, rows(x, na), rows(y, nb)).reshape(shape)
    assert torch.equal(got, cuda_mul.mont_mul(df, x, y))


def test_direct_rows_refuse_other_shapes():
    """Batched, repeating, transposed and unequal operands take the
    broadcast path."""
    df = get_device_field(TF.bn254_fr, "cpu")
    a = _rows(df, 12, 7)
    for x, y in ((a.reshape(3, 4, -1), a[:4]), (a[:4], a[:3]),
                 (a[:4].T.contiguous().T, a[:4]), (a[:4].T, a[:4].T)):
        assert cuda_mul.direct_rows(x, y, df.L) is None


@pytest.mark.parametrize("first", [True, False])
def test_direct_rows_plan_nothing_for_an_empty_operand(first):
    """An empty operand against a broadcast row plans no element, the
    shape broadcasting gives: (0, L) rows times a (1, L) row either way."""
    df = get_device_field(TF.bn254_fr, "cpu")
    a = _rows(df, 3, 8)
    x, y = (a[:0], a[:1]) if first else (a[:1], a[:0])
    assert cuda_mul.direct_rows(x, y, df.L) == (0 if first else 1,
                                                1 if first else 0, 0,
                                                (0, df.L))
    assert cuda_mul.mont_mul(df, x, y).shape == (0, df.L)


@pytest.mark.parametrize("op", ["coset_ntt", "coset_intt"])
def test_power_tables_are_built_once(op, monkeypatch):
    """A second coset transform returns the same limbs from the cached
    twiddle and coset tables, with only the data's products."""
    T = DeviceNTT(TF.bn254_fr, "cpu")
    df = T.df
    calls = []
    mul = df.mul
    monkeypatch.setattr(df, "mul", lambda a, b: calls.append(1) or mul(a, b))
    x = _rows(df, 64, 8)
    first = getattr(T, op)(x)
    n_first = len(calls)
    second = getattr(T, op)(x)
    assert torch.equal(first, second)
    # the data's products: the coset scale, six stages (intt: and n^-1)
    assert len(calls) - n_first == 7 + (op == "coset_intt")
    assert n_first > 2 * (len(calls) - n_first)
    g = TF.bn254_fr.multiplicative_generator
    assert T.power_table(g, 64) is T.power_table(g, 64)
