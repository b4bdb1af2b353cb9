#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`davinci_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

  1. device: the card's name and power limit; build every CUDA kernel of
     `davinci_tpu_torch/csrc/` with nvcc (one process per source).
  2. B1 (G1 point add) on 2^16 random BN254 G1 points plus edge cases,
     limb-equal to its plain PyTorch version; kernel and plain times.
  3. B7 (G2 point add) on 2^14 random BN254 G2 points, the same checks.
  4. A BN254 G1 MSM of n = 2^17 on the card, equal to a host oracle
     (64 distinct points tiled, so per-point scalar sums give the answer).
  5. The ballot-proof circuit (c1, 99,946 constraints) end to end: host
     circuit build, Groth16 setup on the card, one prove with fixed
     randomness that must verify (pairing check), one more timed prove;
     the stage times and the kernel launch counts of the prove.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside this file, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import logging
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0xDA71


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn on the current stream (CUDA events
    around `reps` calls after one warm-up call)."""
    import torch

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
    return {"n": n, "edge_cases": P[0].shape[0] - n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms}


def msm_phase(dev, rng_np, n=1 << 17):
    """BN254 G1 MSM of n points against the tiled host oracle."""
    import numpy as np
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm import msm
    from davinci_tpu_torch.msm.pippenger import NBUCKETS, WINDOW_BITS

    spec = C.bn254_g1
    dc = get_device_curve(spec, dev)
    base_pts = [spec.gen.mul(int(k)) for k in rng_np.integers(1, 2**31, 64)]
    P64 = dc.encode_points(base_pts)
    pts = tuple(a.repeat(n // 64, 1) for a in P64)
    W = -(-spec.r.bit_length() // WINDOW_BITS)
    S = rng_np.integers(0, NBUCKETS, size=(n, W), dtype=np.int32)
    S[:, -1] &= 3  # top window of a reduced 254-bit scalar
    t0 = time.perf_counter()
    out = msm(dc, pts, torch.as_tensor(S, device=dev))
    got = dc.decode_points(tuple(a[None] for a in out))[0]
    first_s = time.perf_counter() - t0
    S64 = S.astype(np.int64)
    want = spec.infinity()
    for b in range(64):
        per_window = S64[b::64, :].sum(axis=0)
        total = sum(int(v) << (WINDOW_BITS * j) for j, v in enumerate(per_window))
        want = want.add(base_pts[b].mul(total % spec.r))
    check(got == want, "MSM result differs from the host oracle")
    t0 = time.perf_counter()
    out = msm(dc, pts, torch.as_tensor(S, device=dev))
    torch.cuda.synchronize()
    return {"n": n, "first_s": first_s, "s": time.perf_counter() - t0}


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
    from davinci_tpu_torch import log
    from davinci_tpu_torch.ec import cuda_add, get_device_curve

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
    regs = [ln.strip() for src in sorted(cuda_build.CSRC.glob("*.cu"))
            for ln in cuda_build.ptxas_log(src.stem).read_text().splitlines()
            if "registers" in ln or "spill" in ln]
    say(f"[1] built {sorted(times)} in {build_s:.3f} s; ptxas: {regs}")

    rng = random.Random(SEED)
    rng_np = np.random.default_rng(SEED)
    kernels = cuda_add.KERNELS
    g1 = get_device_curve(C.bn254_g1, dev)
    g2 = get_device_curve(C.bn254_g2, dev)
    res = {cuda_add.B1.name: point_add_phase(cuda_add.B1, C.bn254_g1, g1, 256, rng)}
    say(f"[2] B1 {res[cuda_add.B1.name]}")
    res[cuda_add.B7.name] = point_add_phase(cuda_add.B7, C.bn254_g2, g2, 128, rng)
    say(f"[3] B7 {res[cuda_add.B7.name]}")

    say(f"[4] G1 MSM equal to the host oracle: {msm_phase(dev, rng_np)}")

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
         "max_abs_err": res[k.name]["max_abs_err"], "ms": res[k.name]["ms"],
         "plain_ms": res[k.name]["plain_ms"]}
        for k in kernels
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
