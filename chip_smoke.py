#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`davinci_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

  1. device: the card's name and power limit; build every CUDA kernel of
     `davinci_tpu_torch/csrc/` with nvcc (one process per source).
  2. B1 (G1 point add) on 2^16 random BN254 G1 points plus edge cases,
     limb-equal to its plain PyTorch version; kernel and plain times.
  3. B7 (G2 point add) on 2^14 random BN254 G2 points, the same checks.
  4a. The fused-pipeline BN254 G1 MSM (`_msm_fused`, the G2 path) at
     n = 2^17, equal to a host oracle (64 distinct points tiled, so
     per-point scalar sums give the answer).
  4b. The scan-path G1 MSM (`_msm_scan`, kernels B2-B5 and B1) at
     n = 2^17 against the same oracle, recording the inputs of B2-B5;
     then an edge-case MSM through `msm` (scalars 0, 1 and r-1, a run of
     equal scalars, digits that carry across windows, an infinity base).
  4c. B2-B5 each against their plain version, limb for limb, on the
     inputs recorded in 4b; kernel and plain times, and each kernel's
     bound.
  5. The ballot-proof circuit (c1, 99,946 constraints) end to end: host
     circuit build, Groth16 setup on the card, one prove with fixed
     randomness that must verify (pairing check), one more timed prove;
     the stage times and the kernel launch counts of the prove, the main
     path (every G1 MSM on the scan path, the G2 MSM fused).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside this file, the script exits non-zero and
prints no result.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its 32-bit integer multiplies over the H100 SXM's multiply
rate, 64 per clock on each of 132 SMs at 1.98 GHz (the CUDA C++
programming guide's throughput table for compute capability 9.0).  The
multiplies are counted from csrc/field.cuh: a field mul is 136 32x32->64
products and 9 low-half products; a complete add (RCB15 Alg 7) is 14
field muls, a mixed add (Alg 8) 13, a G2 add 14 Fp2 muls of 3 each.
"""

from __future__ import annotations

import json
import logging
import random
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0xDA71

HBM_BYTES_PER_S = 3.35e12
MULTS_PER_S = 132 * 64 * 1.98e9
MULTS_PER_FIELD_MUL = 136 + 9
FIELD_MULS = {"add": 14, "mixed": 13, "add_g2": 14 * 3}


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds per call of fn on the current stream (CUDA events
    around `reps` calls, after one warm-up call unless `warm` is false)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, adds, kind):
    """(bound_ms, bound_by) for `nbytes` moved and `adds` point adds of
    `kind` (see FIELD_MULS)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = adds * FIELD_MULS[kind] * MULTS_PER_FIELD_MUL / MULTS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def max_err(got, want):
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip(flat(got), flat(want)))


def flat(t):
    """Nested tuples of tensors -> a list of tensors."""
    if isinstance(t, (tuple, list)):
        return [x for part in t for x in flat(part)]
    return [t]


def ptxas_usage(log_path):
    """(kernel, "R registers, S bytes spilled") for each entry function of
    an nvcc -Xptxas -v report."""
    name = None
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                      r"(?:I\d+(\w+?)E)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            yield name, f"{m.group(1)} registers, {spill} bytes spilled"
            name = None


class StageTimes(logging.Handler):
    """Collects the `took_s` of the package's timed log events."""

    def __init__(self):
        super().__init__()
        self.took = {}

    def emit(self, record):
        kv = getattr(record, "kv", None) or {}
        if "took_s" in kv:
            self.took[record.getMessage()] = kv["took_s"]


def random_points(dc, spec, k, rng):
    """k*k random points in projective form: the host makes k points, the
    card adds every pair with the plain composition (random Z)."""
    import torch

    from davinci_tpu_torch.ec import cuda_add

    base = dc.encode_points([spec.gen.mul(rng.randrange(1, spec.r))
                             for _ in range(k)])
    i = torch.arange(k * k, device=dc.device)
    p = tuple(a[i // k] for a in base)
    q = tuple(a[i % k] for a in base)
    return cuda_add.rcb15_plain(dc, p, q), base


def edge_cases(dc, base):
    """(P, Q) pairs: O + B, B + O, B + B, B + (-B), O + O."""
    import torch

    m = base[0].shape[0]
    ident = dc.identity((m,))
    neg = dc.neg(base)
    lhs = (ident, base, base, base, ident)
    rhs = (base, ident, base, neg, ident)
    cat = lambda pts: tuple(torch.cat([pt[c] for pt in pts]) for c in range(3))
    return cat(lhs), cat(rhs)


def point_add_phase(kernel, spec, dc, k, rng):
    """Kernel vs plain on k*k random points plus the edge cases; spot
    checks a few results against host affine arithmetic."""
    import torch

    from davinci_tpu_torch.ec import cuda_add

    pts, base = random_points(dc, spec, k, rng)
    n = pts[0].shape[0]
    shift = rng.randrange(1, n)
    other = tuple(torch.roll(a, shift, 0) for a in pts)
    el, er = edge_cases(dc, base)
    P = tuple(torch.cat([a, b]) for a, b in zip(pts, el))
    Q = tuple(torch.cat([a, b]) for a, b in zip(other, er))
    got = dc.add(P, Q)  # on a CUDA tensor: the kernel
    want = cuda_add.rcb15_plain(dc, P, Q)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0, f"{kernel.name} differs from its plain version")
    # host spot check: random pairs and every edge case
    idx = [rng.randrange(n) for _ in range(4)] + list(range(n, P[0].shape[0]))
    sel = lambda t: tuple(a[idx] for a in t)
    host = [a.add(b) for a, b in zip(dc.decode_points(sel(P)),
                                      dc.decode_points(sel(Q)))]
    check(dc.decode_points(sel(got)) == host, f"{kernel.name} vs host add")
    Pn = tuple(a[:n] for a in pts)
    Qn = tuple(a[:n] for a in other)
    ms = cuda_ms(lambda: dc.add(Pn, Qn), 20)
    plain_ms = cuda_ms(lambda: cuda_add.rcb15_plain(dc, Pn, Qn), 3)
    nbytes = 9 * Pn[0][0].numel() * 4 * n  # 6 coordinates in, 3 out
    bound_ms, bound_by = bound(
        nbytes, n, "add_g2" if dc.ops.coord_ndim == 2 else "add")
    return {"n": n, "edge_cases": P[0].shape[0] - n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def tiled_msm_case(dev, rng_np, n=1 << 17):
    """A BN254 G1 MSM of n points tiling 64 distinct bases, with random
    12-bit windows, and its host oracle (per-base scalar sums)."""
    import numpy as np
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm.pippenger import NBUCKETS, WINDOW_BITS

    spec = C.bn254_g1
    dc = get_device_curve(spec, dev)
    base_pts = [spec.gen.mul(int(k)) for k in rng_np.integers(1, 2**31, 64)]
    P64 = dc.encode_points(base_pts)
    pts = tuple(a.repeat(n // 64, 1) for a in P64)
    W = -(-spec.r.bit_length() // WINDOW_BITS)
    S = rng_np.integers(0, NBUCKETS, size=(n, W), dtype=np.int32)
    S[:, -1] &= 3  # top window of a reduced 254-bit scalar
    S64 = S.astype(np.int64)
    want = spec.infinity()
    for b in range(64):
        per_window = S64[b::64, :].sum(axis=0)
        total = sum(int(v) << (WINDOW_BITS * j) for j, v in enumerate(per_window))
        want = want.add(base_pts[b].mul(total % spec.r))
    return dc, pts, torch.as_tensor(S, device=dev), want


def msm_phase(fn, case):
    """fn(dc, points, scalar_limbs) against the case's oracle; the first
    call's time and one more."""
    import torch

    dc, pts, S, want = case
    t0 = time.perf_counter()
    out = fn(dc, pts, S)
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    first_s = time.perf_counter() - t0
    check(got == want, "MSM result differs from the host oracle")
    t0 = time.perf_counter()
    fn(dc, pts, S)
    torch.cuda.synchronize()
    return {"n": S.shape[0], "first_s": first_s, "s": time.perf_counter() - t0}


def edge_msm_phase(dev, n=3000):
    """The entry point `msm` (the scan path for G1 on the card) on edge
    cases: scalars 0, 1 and r-1, digits 2047, 2048 and 4095 that carry
    across windows, a run of equal scalars; bases tiled from 7 points
    and the point at infinity."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm import msm
    from davinci_tpu_torch.msm.pippenger import scalars_to_limbs

    spec = C.bn254_g1
    dc = get_device_curve(spec, dev)
    rng = random.Random(SEED + 1)
    base = [spec.gen.mul(rng.randrange(1, spec.r)) for _ in range(7)]
    base.append(spec.infinity())
    w = 1 << 12
    scalars = [rng.randrange(spec.r) for _ in range(n)]
    scalars[:7] = [0, 1, spec.r - 1, w**21 - 1,
                   sum(2048 * w**j for j in range(21)),
                   sum(2047 * w**j for j in range(21)),
                   sum((2047 + j % 3) * w**j for j in range(21))]
    scalars[100:400] = [scalars[100]] * 300
    pts = dc.encode_points([base[i % 8] for i in range(n)])
    S = torch.as_tensor(scalars_to_limbs(spec, scalars), device=dev)
    got = dc.decode_points(tuple(a[None] for a in msm(dc, pts, S)))[0]
    want = spec.infinity()
    for b, pt in enumerate(base):
        want = want.add(pt.mul(sum(scalars[b::8]) % spec.r))
    check(got == want, "edge-case MSM differs from the host oracle")
    return {"n": n, "equal": True}


class Capture:
    """While installed, records the arguments of the first call of each
    scan-path kernel wrapper (B2-B5), so they can be replayed."""

    WRAPPERS = ("_bucket_scan", "bucket_reduce_kernel",
                "suffix_reduce_kernel", "horner_kernel")

    def __init__(self):
        self.args = {}

    def __enter__(self):
        from davinci_tpu_torch.msm import bucket_kernel as bk

        self.saved = {name: getattr(bk, name) for name in self.WRAPPERS}
        for name, fn in self.saved.items():
            def rec(*args, _name=name, _fn=fn):
                self.args.setdefault(_name, args)
                return _fn(*args)
            setattr(bk, name, rec)
        return self

    def __exit__(self, *exc):
        from davinci_tpu_torch.msm import bucket_kernel as bk

        for name, fn in self.saved.items():
            setattr(bk, name, fn)


def scan_kernels_phase(args):
    """B2-B5 against their plain versions on the main path's inputs: the
    largest difference, kernel and plain times, the bound."""
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.msm import bucket_kernel as bk
    from davinci_tpu_torch.msm.pippenger import WINDOW_BITS

    dc, pts_arr, keys_arr, signed = args["_bucket_scan"]
    rows, LP, nl = pts_arr.shape
    L = dc.df.L
    bucket = (keys_arr >> 1) if signed else keys_arr
    mixed_adds = int((bucket[1:] == bucket[:-1]).sum())
    _, buckets = args["bucket_reduce_kernel"]
    _, Wt, NB = buckets[0].shape
    C = bk.REDUCE_C if NB % bk.REDUCE_C == 0 else NB
    _, s = args["suffix_reduce_kernel"]
    Ks, _, M = s.shape
    _, sums, W, wbits = args["horner_kernel"]
    B = sums[0].shape[1] // W
    check(wbits == WINDOW_BITS, "Horner's doublings per window")
    word = 4
    table = [
        (K.B2, lambda: bk._bucket_scan(dc, pts_arr, keys_arr, signed),
         lambda: bk._bucket_scan_plain(dc, pts_arr, keys_arr, signed),
         rows * nl * (LP + 1 + 3 * L) * word, mixed_adds, "mixed",
         {"rows": rows, "lanes": nl}),
        (K.B3, lambda: bk.bucket_reduce_kernel(dc, buckets),
         lambda: bk._bucket_reduce_plain(dc, buckets, C),
         (3 * L * Wt * NB + 6 * L * Wt * C) * word,
         Wt * C * (2 * (NB // C) - 1), "add", {"Wt": Wt, "NB": NB, "C": C}),
        (K.B4, lambda: bk.suffix_reduce_kernel(dc, s),
         lambda: bk._suffix_reduce_plain(dc, s),
         (Ks + 2) * 3 * L * M * word, M * (2 * Ks - 1), "add",
         {"K": Ks, "M": M}),
        (K.B5, lambda: bk.horner_kernel(dc, sums, W, wbits),
         lambda: bk._horner_plain(dc, sums, W, wbits),
         3 * L * (W + 1) * B * word, B * (W - 1) * (wbits + 1), "add",
         {"W": W, "B": B}),
    ]
    res = {}
    for kernel, run, plain, nbytes, adds, kind, shape in table:
        got = run()
        want = plain()
        err = max_err(got, want)
        check(err == 0, f"{kernel.name} differs from its plain version")
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(plain, 1, warm=False)
        bound_ms, bound_by = bound(nbytes, adds, kind)
        res[kernel.name] = {**shape, "adds": adds, "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by}
        say(f"[4c] {kernel.name} {res[kernel.name]}")
    return res


def ballot_circuit():
    """The full-size ballot-proof circuit (c1) with the inputs of the
    reference's benchmark, built by the package's host copy."""
    from davinci_tpu_torch.ballotmode import BallotMode
    from davinci_tpu_torch.circuits.ballotproof import (
        build_ballot_proof_circuit,
        make_ballot,
    )
    from davinci_tpu_torch.elgamal import generate_key

    t0 = time.perf_counter()
    rng = random.Random(0xF3)
    pub, _ = generate_key(rng)
    bw = make_ballot(
        12345, BallotMode(), (pub.x, pub.y), rng.randrange(2**160),
        rng.randrange(1, 2**200), [1, 0, 0, 0, 0, 0, 0, 0],
    )
    cs = build_ballot_proof_circuit(bw)
    build_s = time.perf_counter() - t0
    check(len(cs.constraints) == 99946, "c1 constraint count")
    say(f"[5] c1 built: {len(cs.constraints)} constraints, "
        f"{cs.num_variables} variables in {build_s:.3f} s")
    return cs, [bw.inputs_hash()], build_s


def groth16_phase(dev, cs, public, kernels, stages):
    """Setup on the card, a prove with fixed randomness that must verify
    (and fail on a wrong public input), one more timed prove."""
    import torch

    from davinci_tpu_torch.groth16 import Groth16

    out = {"constraints": len(cs.constraints), "variables": cs.num_variables}
    g16 = Groth16("bn254", device=dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    pk, vk = g16.setup(cs, rng=random.Random(SEED))
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    out["setup_launches"] = {k.name: k.launches for k in kernels}
    say(f"[5] setup on the card: {out['setup_s']:.3f} s, launches "
        f"{out['setup_launches']}")

    for k in kernels:
        k.launches = 0
    stages.took.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = g16.prove(pk, cs, r_rand=7, s_rand=11)
    out["prove_first_s"] = time.perf_counter() - t0
    out["prove_launches"] = {k.name: k.launches for k in kernels}
    out["stages_first_s"] = dict(stages.took)
    for k in kernels:
        check(k.launches > 0, f"{k.name} was not launched by the prove")
    t0 = time.perf_counter()
    check(g16.verify(vk, proof, public), "proof does not verify")
    out["verify_s"] = time.perf_counter() - t0
    check(not g16.verify(vk, proof, [public[0] + 1]),
          "proof verifies against a wrong public input")
    say(f"[5] prove: {out['prove_first_s']:.3f} s, verify true in "
        f"{out['verify_s']:.3f} s, launches {out['prove_launches']}")

    stages.took.clear()
    t0 = time.perf_counter()
    proof2 = g16.prove(pk, cs)
    out["prove_s"] = time.perf_counter() - t0
    out["stages_s"] = dict(stages.took)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    check(g16.verify(vk, proof2, public), "second proof does not verify")
    say(f"[5] timed prove: {out['prove_s']:.3f} s, stages {out['stages_s']}, "
        f"peak device memory {out['peak_mem_gb']:.2f} GiB")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "davinci_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: davinci_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from davinci_tpu_torch import cuda_build
    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch import log
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm import pippenger

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    t0 = time.perf_counter()
    times = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    # ptxas's report of every kernel library (built now or earlier)
    regs = {name: usage for src in sorted(cuda_build.CSRC.glob("*.cu"))
            for name, usage in ptxas_usage(cuda_build.ptxas_log(src.stem))}
    say(f"[1] built {sorted(times)} in {build_s:.3f} s; ptxas: {regs}")

    rng = random.Random(SEED)
    rng_np = np.random.default_rng(SEED)
    kernels = K.KERNELS
    g1 = get_device_curve(C.bn254_g1, dev)
    g2 = get_device_curve(C.bn254_g2, dev)
    res = {K.B1.name: point_add_phase(K.B1, C.bn254_g1, g1, 256, rng)}
    say(f"[2] B1 {res[K.B1.name]}")
    res[K.B7.name] = point_add_phase(K.B7, C.bn254_g2, g2, 128, rng)
    say(f"[3] B7 {res[K.B7.name]}")

    case = tiled_msm_case(dev, rng_np)
    say(f"[4a] fused G1 MSM equal to the host oracle: "
        f"{msm_phase(pippenger._msm_fused, case)}")
    with Capture() as cap:
        scan = msm_phase(pippenger._msm_scan, case)
    check(sorted(cap.args) == sorted(Capture.WRAPPERS), "B2-B5 recorded")
    say(f"[4b] scan-path G1 MSM equal to the host oracle: {scan}")
    say(f"[4b] edge-case G1 MSM through msm: {edge_msm_phase(dev)}")
    res.update(scan_kernels_phase(cap.args))
    del case, cap

    stages = StageTimes()
    log.init()
    logging.getLogger("davinci").addHandler(stages)
    cs, public, build_s = ballot_circuit()
    c1 = groth16_phase(dev, cs, public, kernels, stages)
    c1["build_s"] = build_s

    say(f"[5] c1 summary {json.dumps(c1)}")
    say(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": c1["prove_launches"][k.name],
         **{key: res[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for k in kernels
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
