#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`davinci_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

  1. device: the card's name and power limit; build every CUDA kernel of
     `davinci_tpu_torch/csrc/` with nvcc, each source at L = 22 and
     L = 32, and point_add.cu, bucket.cu and mont_mul.cu at L = 64 too
     (BW6-761; one process per library, all started together).
  2. B1 (G1 point add) at L = 22 (BN254) and L = 32 (BLS12-381) on 2^16
     random sums plus edge cases and points rescaled near p - 1, on
     limb-major (L, n) planes (the scan path's entry) and through the row
     wrapper (`DeviceCurve.add`), limb-equal to its plain PyTorch
     version; event, device, plain and bound times on planes at 22,
     45,056 (the scan path's leftover merge) and 2^16 adds, and through
     the rows at 2^16.
  3. B7 (G2 point add) at L = 22 (BN254) and L = 32 (BLS12-377, whose
     Fp2 has u^2 = -5, and BLS12-381) on random G2 points plus edge cases
     and points rescaled near p - 1, at n = 1 (the G2 Horner's launches),
     2^14, 45,056 and 90,112 (the b2 MSM's accumulate and reduce launches),
     limb-equal to its plain version; kernel (events and profiler device
     time), plain and bound times at each n.
  3b. A 4,096-point BLS12-377 G2 MSM through `msm` (the fused route on B7
     and B5's G2 build at L = 32) against a host oracle, with their
     launches: the path the L = 32 builds of B7 and B5-G2 serve.
  4a. The fused-pipeline BN254 G1 MSM (`_msm_fused`, the G2 path) at
     n = 2^17, equal to a host oracle (64 distinct points tiled, so
     per-point scalar sums give the answer).
  4b. The scan-path G1 MSM (`_msm_scan`, kernels B2-B5 and B1) at
     n = 2^17 against the same oracle, recording the inputs of B2-B5;
     then an edge-case MSM through `msm` (scalars 0, 1 and r-1, a run of
     equal scalars, digits that carry across windows, an infinity base).
  4c. B2-B5 each against their plain version, limb for limb, on the
     inputs recorded in 4b (B5 at both of its shapes, the window Horner
     and the reduce's combine, a two-window step; B4, K = 256 and M = 44: against the plain
     version of its split order, and as points against the reference's
     order); kernel (events and profiler device time) and plain times,
     each kernel's bound and ptxas's registers and spills, and B5's
     microseconds per dependent add.
  5. The ballot-proof circuit (c1, 99,946 constraints) end to end: host
     circuit build, Groth16 setup on the card, one prove with fixed
     randomness that must verify (pairing check), one more timed prove;
     the stage times and the kernel launch counts of the prove, the main
     path (every G1 MSM on the scan path, the G2 MSM fused, every field
     product on B6, the G2 window combine one launch of B5's G2 build);
     each L = 22 kernel must be launched, in the first prove and in the
     timed one (the steady prove, whose counts the kernels line gives: the
     first builds the NTT's tables); a line of its own gives the launches
     of B1, B5 and B6 in both.  Beside them the prove's B7
     launches by batch size (none of one add may be left), and the times
     of its four G1 MSMs and its G2 MSM.
  5b. B5's G2 build against its plain version, limb for limb, on the
     window sums of c1's b2 MSM (L = 22) and of 3b's MSM (L = 32): event
     and device times, the plain time, the bound and the microseconds
     per dependent add of its 273-add chain.
  6. B6 (Montgomery product) on 2^16 random elements plus 0, 1, p - 1 and
     raw values up to R - 1 through to_mont, for every field it is built
     for (L = 22 and L = 32), on rows, a broadcast row ((1, L) and (L,)),
     repeating rows and a view at an odd row offset, limb-equal to its
     plain version; event, device, plain and host times (the host's per
     call from a loop without a synchronize).
  7. The sequencer's blob path at full size (BLS12-381, L = 32): the
     trusted setup's load (host), then `pack_batch_blob(..., with_kzg=True)`
     of a synthetic 60-vote batch (2,193 cells), whose commitment and
     proof `verify_kzg_proof` (host pairing) must accept, and reject with
     y + 1; the launch counts of that run, the second path (each L = 32
     G1 kernel must be launched).  Then a sparse blob's commitment and a
     4,096-point MSM of 64 tiled points against host oracles, recording
     the inputs of B1-B5 (B1: its first planes, 45,056 adds), and B1-B5
     at L = 32 against their plain versions on them, as in 4c.
  8. The point-add experiment (`davinci_tpu_torch.ec.addk_exp`, kernel B8
     in four designs of the BN254 G1 complete add: v2d, lazy, kara and
     the addonly diagnostic): its `run_variant` for every variant at the
     experiment's n = 22 x 2,048, the third path (each variant must be
     launched) and each variant's instructions per add, IMAD-family and
     multiplying, from `cuobjdump -sass`; then, at that n (and at 2^20
     with `--b3-b8`), each variant against its plain version on the
     experiment's points
     plus the edge cases and points rescaled near p - 1, and v2d, lazy
     and kara against B1 on the same points; per variant the 30-launch
     chain's time (events, and device time from the profiler), the plain
     time and the bound, with B1's chain on the same planes beside them.

  9. The sequencer's per-vote prover on the port's own modules
     (committed-377: the vote verifier's arithmetic on its curve, 620
     emulated BN254 Fp products range-checked by 2^12-entry lookups under
     the commitment extension, 99,436 constraints): [9a] the build; [9b]
     `ArtifactStore.load_or_setup` on the card (a store under build/), with
     the sizes of pk.bin and vk.bin; [9c] `prove_and_verify_committed`,
     which must build once, and `verify_committed` false for public 8 and
     for pok replaced by D; [9d] the solved system saved and loaded, then
     one `prove_committed_reuse` proof, verified, with its stage
     times (the D and pok MSMs: `groth16.commit`), the launches of the
     kernels of this path (B1-B5, B7 and B5's G2 build at L = 32, B6 at
     L = 22: each must be launched) and peak device memory; [9e] a second
     store on the directory, which must load with no setup, proves and
     verifies; then one more reuse prove with the first and the largest
     call of each kernel wrapper recorded, each made again against its
     plain version (B1-B5, B5's G2 build and B7 at L = 32, B6 on
     BLS12-377's Fr: every call must be equal), with the kernel's and the
     plain version's times on the largest call; [9f] a plain BLS12-381 Groth16 at a 2^12 domain, set
     up, proved and verified true and false on the card.
  11a. B1-B6 at L = 64 (BW6-761) against their plain versions: B1 on
     both groups (G1, b = -1, and G2, b = 4, both over the 761-bit Fp) on
     planes and rows with edge cases and points rescaled near p - 1
     (timed at 22, 45,056 and 2^16 adds), B6 on BW6-761's Fp (2^16
     products, 0, 1, p - 1, raw values up to R - 1, broadcast, repeating
     and offset operands), and a 4,096-point G1 and G2 MSM through `msm`
     (the scan path for both) against host oracles, whose B1 planes and
     B2-B5 calls are held against their plain versions (B4 against its
     split order; B2 on G1's 3b = -3) with event, device, plain and bound
     times and ptxas's registers and spills.
  13. The sequencer (`sequencer/pipeline.py`) with its production provers
     (`sequencer/provers.py`'s `ProtocolProvers` at "prove" for c2, c3
     and c4), one election on the card: c1's ballot (phase 5), c2's
     client material of phase 10's construction [10a] (BN254 inner
     pairing with c1's key, secp256k1 signed by `ethereum.sign`, the
     lookup tier; c1's key and proof written to build/c1_vector.json), a
     census of 8 voters whose compressed proof the sequencer decompresses,
     c3 at one slot, c4 at `votes_per_batch` = 2 slots (the production
     tiers: 64 levels, a 20-level census, the blob on the full 4,096-cell
     domain with its KZG, lookups) and c5 at full size, every key through
     one store under build/ (removed at the end; `DAVINCI_ARTIFACTS_DIR`
     too, the finalizer's store).  The ballot enters through the node's
     HTTP API (`api.serve` on 127.0.0.1, with a jobs manager and c1's key
     as its ballot verifier, one host pairing a vote): the voter's census
     proof is fetched from it, three votes are refused first (another
     key's signature, the inputs hash + 1, an address outside the
     census: 401 each), then `POST /votes` takes the wire ballot with
     the EIP-191 signature of c2's key over the vote ID, the census proof
     and c1's proof, and the item it queues must be the direct route's
     but for the voter's key, which it holds as hex strings (queue C:
     the worker's provers turn them into ints).  A proving worker
     (`WorkerClient`, over HTTP to the same server) fetches the job and
     proves c2 with the sequencer's provers (the build, the setup through
     the store, the first committed prove and verify), and
     `/sequencer/workers` must show its one success.  One line for the
     worker's job and a tick each (`tick_ballot`, which must find no
     pending ballot, `tick_aggregate`, `tick_transition`,
     `tick_onchain`, then `tick_finalizer(prove_real=True)` once the
     chain ends the process): its seconds, the kernels it launched (each
     of its circuits' kernels must be), its stage times, peak device
     memory and the constraints of what it built; the vote's status over
     HTTP after the intake, the worker and the settlement, and `/info`
     at the end.  Between the ticks, on the runtimes and the systems
     the pipeline made: `verify_vote` true for c2's proof and false for
     its vote hash + 1, and one steady c2 `prove_committed_reuse`,
     verified and refused with a tampered public value, the first and the
     largest call of each kernel wrapper replayed against its plain
     version [10d]; c3's prove's kept kernel calls (recorded during the
     tick) replayed, its proof refused with the batch hash + 1 [11d]; c4's
     proof refused with root_after + 1, its blob's y checked against the
     host's barycentric evaluation at z, one steady reuse prove refused
     and replayed [12c]; the chain's root is the state's, the vote
     SETTLED, the results the ballot's tally, c5's proof refused with
     results[0] + 1 [12d].  The reference's canonical dummy vote passes
     no ballot proof, which the production c2 cannot build, so the provers
     are given this ballot's c2 proof as their dummy before
     `tick_aggregate`.
  14. The node's CLI, through `cli.main` with `sys.argv` set, before
     phase 13's store is removed; a line per command with its seconds,
     the kernels it launched, its stage times and peak device memory.
     `send-blob --cells -n 1 --wait` against the port's `FakeEthNode` on
     127.0.0.1: a version-1 sidecar of 128 EIP-7594 cell proofs (the
     iNTT, the quotients, the NTT and one `msm_many` of 2,816 window rows
     over the ceremony's Lagrange points: B6, then B1-B5 at L = 32),
     signed and submitted; the node decodes and validates it.  Beside it,
     `compute_cell_proofs_device` on the same blob with its stage times:
     its proofs are the sidecar's, cells 0, 64 and 127 are the host
     path's `compute_cell_proof` and pass `verify_cell_proof`, cell 0's
     proof is refused for cell 127, and its kernel calls (the first and
     the largest of each wrapper) are replayed against their plain
     versions, with the bounds of B1's to B4's largest call.  `e2e
     --votes 4 --prove-results` over the store: c5's key is loaded, not
     set up again, and the results are proved on the card.
     `circuit-compile --export-only` over the store: one `.sol` per BN254
     key (c4's and c5's), named by its structure hash.
  15. The last modules of the port, on phase 5's c1 key and proof: [15a]
     `get_device_poseidon(t)` on the card at t = 3 with 2^16 rows (one
     level of a 64k-leaf tree), t = 17 with 4,096 (16-field ballots), and
     t = 2 and t = 5 with 1,024: rows 0, the last and 254 sampled ones
     equal to the host `poseidon_hash`, with the hashes a second, B6's
     launches a call and peak device memory.  [15b] A world-size-1 NCCL
     group in this process (`parallel.distributed_init` over a file
     store under build/, `get_mesh`): `sharded_ntt` / `sharded_intt` at
     2^17 limb-equal to `ntt` / `intt`, `sharded_msm` of phase 4's 2^17
     G1 case and of a 2^14-point BN254 G2 set equal to `msm` and to their
     host oracles, then c1 proved with `Groth16.set_mesh` (r = 7, s = 11),
     equal in a, b and c to phase 5's proof, verified and refused for a
     tampered public input, its seconds beside phase 5's steady prove and
     the launches of B1-B7 and B5's G2 build (each above 0); the group is
     destroyed after.  One card cannot hold an NCCL group of two ranks, so
     the collectives are trivial here; tests/test_torch_sharded.py holds
     the multi-rank logic over gloo at D = 2 and 4.
A line before each phase gives the seconds since the run began.

The line before the last is a JSON object with one entry per kernel (B8:
per variant) and limb count, with its registers and spills from ptxas
and its launches on the node's path (phases 13 and 14; B8's in phase 8);
the last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the package beside this file, the script exits non-zero and
prints no result.

    python3 chip_smoke.py --g2-add

runs phase 3 alone (after building csrc/point_add.cu), for the curves
whose limb count has a build of B7: the way to time another checkout's
B7 at the same shapes.

    python3 chip_smoke.py --b1-b6

times B1 (through the rows, and on planes where the checkout has that
entry) at 45,056 and 2^16 adds on BN254 and BLS12-381 G1, and B6 at 2^16
on BN254 Fr and BLS12-381 Fp (event, device and host times), in the same
way for another checkout.

    python3 chip_smoke.py --b3-b8

times B3 at c1's and the blob's shape on random sums, and runs phase 8,
in the same way for another checkout.

    python3 chip_smoke.py --c2

runs phase 5 and phase 10, c2's flow without the sequencer: its witness
[10a], one host build [10b], setup through a store [10c] and one steady
reuse prove with its kernel calls replayed [10d]; then the sequencer's
per-vote route at full size (`sequencer/provers.py`'s `_c2_prove`): `prove_and_verify_committed`
(one build more, re-solved through the `_refinalize` hook) [10e]; six
more steady reuse proves, which time the upload of the key sets above a
segment three ways, each twice in the order resident, port, synchronous,
synchronous, port, resident [10g]: the whole sets kept on the card, as
before the port streamed them (uploaded before the timer); the port's
own streaming; each segment copied on the compute stream as its MSM
starts; and a second store on the same directory that must load with
no setup, then prove and verify [10f], each with 10d's record (the
replay against the plain versions is 10d's alone).

    python3 chip_smoke.py --c3

runs phases 5 and 10 (`--c2`'s; the prove without the replay), then the
aggregator at full size, `VOTES_PER_BATCH` = 60 slots: the canonical
dummy vote (`sequencer/provers.py:162-190`: a c2 proof, under c2's key,
of the fixed dummy witness; the production c2 verifies an inner proof,
so the dummy carries phase 5's c1 proof and inputs hash) [11e], c3 with
phase 10's proof as the one real vote and the dummy in the other 59
slots [11b], setup on the card in memory [11c], `prove_and_verify`
[11d] and one more prove [11f], each verified and refused with the batch
hash + 1, then that key written through the store a section at a time
(the host's resident set before, at its peak and after the write) and
a second store on the same directory that must load it with no setup,
then prove and verify [11g] (no kernel replay).  From the setup on it
prints the card's memory as `--c4` does.

    python3 chip_smoke.py --c4 [N]

runs c4 alone at N votes (default 60, the production batch: its count
must be the reference's 14,993,781) with `--c3`'s flow: the witness,
made by the port's `Sequencer` from a seeded election of N ballots, and
the build [12a], setup on the card in memory [12b],
`prove_and_verify_committed` [12c] and one steady reuse prove [12e],
each verified and refused with root_after + 1, then the key written
through the store a section at a time and a second store on the same
directory that must load it with no setup, prove and verify [12f] (no
kernel replay); the host's resident set is sampled around each step and
printed every 30 s.  The card's memory: after setup and after each
prove a line of the largest live blocks of `torch.cuda.memory_snapshot()`,
each named by its holder (a key set's upload or plane pack,
`pk._torch_idx`, `cs._torch_csr`, the NTT's stage and power tables,
setup's fixed-base tables; "other" for none), then a line of allocated,
reserved and peak GiB with the bytes of each holder; inside each prove
the allocated, reserved and peak GiB as each stage ends
(`stage_memory`: `groth16.commit`, `groth16.refinalize`,
`groth16.witness_reduce_dev`, `groth16.quotient_ntt`, `groth16.msms`),
and a last line with the peak of each step (setup, the first and the
steady prove, the store's write and load, the second store's prove).
Key sets above a segment are streamed from the host, segment by
segment, and never held whole on the card.  At 60 votes it needs about
94 GiB of host memory and most of a 3,600 s call.

    python3 chip_smoke.py --c2-size

runs phase 9 alone with committed-377 grown to 23,000 products (3.39M
constraints, the 2^22 domain of the production vote verifier): build,
setup on the card through the store, the first committed prove, one
steady reuse prove and the second store's load and prove (the replay of
9d's kernel calls is left out: the plain versions at 2^22 take minutes).

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its 32-bit integer multiplies over the H100 SXM's multiply
rate, 64 per clock on each of 132 SMs at 1.98 GHz (the CUDA C++
programming guide's throughput table for compute capability 9.0).  The
multiplies are counted from csrc/field.cuh (`mults_per_mul`): with N
words and REM radix bits left, a field mul is N^2 + N^2 32x32->64
products and N low halves, with a REM step N + 1 more (145 at L = 22,
300 at L = 32, 1,176 at L = 64: N = 24, no REM step; B6 reads a raw
operand of N + 1 words at L = 22, 153); BW6-761's G1 and G2 adds are
both Fp adds; a
complete add (RCB15 Alg 7) is 14 field muls, a mixed add (Alg 8) 13, a
G2 add 14 Fp2 muls of 3 each.  Every B8 variant stands on the strict
add's count, the one yardstick of the four; addonly, which multiplies
nothing, on its bytes alone.
"""

from __future__ import annotations

import json
import logging
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0xDA71

HBM_BYTES_PER_S = 3.35e12
MULTS_PER_S = 132 * 64 * 1.98e9
FIELD_MULS = {"mul": 1, "add": 14, "mixed": 13, "add_g2": 14 * 3}
B6_FIELDS = ("bn254_fr", "bn254_fp", "bls12_377_fr", "bls12_381_fr",
             "bls12_377_fp", "bls12_381_fp")
ADDK_SIZES = (22 * 2048, 1 << 20)  # the experiment's n, and a full card
G2_CURVES = ("bn254_g2", "bls377_g2", "bls381_g2")
# one add (the G2 Horner), the table's 2^14, and the b2 MSM's accumulate
# (Wt x COLS) and reduce launches
G2_SIZES = (1, 1 << 14, 22 * 2048, 44 * 2048)


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def lap(tag, t_run):
    """A line with the seconds since the run began, before a phase."""
    say(f"{tag} starts {time.perf_counter() - t_run:.1f} s into the run")


def bumped(values, i):
    """`values` with the one at `i` increased by 1: a tampered public."""
    return [v + (j == i) for j, v in enumerate(values)]


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


def timed_call(fn):
    """(fn's result, the milliseconds of that one call by CUDA events): a
    plain version's time from the call that checks a kernel, where a
    second call would take seconds more."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def host_us_per_call(fn, reps=200):
    """Microseconds of host time per call of fn: a loop of `reps` calls
    without a synchronize (the launches queue on the card), after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def mults_per_mul(L, raw=False):
    """32-bit multiplies of one field.cuh Montgomery product at L limbs
    (`raw`: B6's first operand has the extra word of a value below R)."""
    n, rem = 12 * L // 32, 12 * L % 32
    na = n + (1 if raw and rem else 0)
    return n * na + n * n + (n if rem else 0) + n + (1 if rem else 0)


def device_ms(fn, reps, kernel):
    """Mean device time per call of the CUDA kernels whose name holds
    `kernel`, from a torch.profiler trace of `reps` calls after one
    warm-up call; None where the trace holds no device time for them.
    Beside `cuda_ms`, which also counts the host's launch gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or 0
             for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us else None


def bound(nbytes, ops, kind, L=22):
    """(bound_ms, bound_by) for `nbytes` moved and `ops` point adds of
    `kind` (see FIELD_MULS; "mul": B6 products) at L limbs."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops * FIELD_MULS[kind] * mults_per_mul(L, raw=kind == "mul")
             / MULTS_PER_S)
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


def kernel_name(mangled):
    """The `..._kernel` name inside a mangled entry function name (it is
    prefixed by its length: "15addk_v2d_kernel"), with "<Fp2>" for the
    Fp2 instantiation; None where there is none."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            name = mangled[m.end():m.end() + int(m.group()[k:])]
            if re.fullmatch(r"[a-z_][a-z0-9_]*_kernel", name):
                rest = mangled[m.end() + len(name):]
                return name + ("<Fp2>" if "Fp2" in rest else "")
    return None


def ptxas_usage(log_path):
    """(kernel, "R registers, S bytes spilled") for each entry function of
    an nvcc -Xptxas -v report."""
    name = None
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            yield name, f"{m.group(1)} registers, {spill} bytes spilled"
            name = None


def sass_counts(lib_path):
    """{function: {"instructions": n, "imad": n, "imad_mul": n}} for each
    function of a built library, from `cuobjdump -sass`: its instructions
    (NOPs left out), its IMAD-family instructions, and those of them that
    multiply (all but IMAD.MOV, IMAD.SHL and IMAD.IADD, the moves, shifts
    and adds that nvcc also puts on the multiply pipe).  Entry functions
    go by their `..._kernel` name."""
    from davinci_tpu_torch import cuda_build

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1)) or m.group(1)
            cur = counts.setdefault(
                name, {"instructions": 0, "imad": 0, "imad_mul": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if m is None or cur is None or m.group(1) == "NOP":
            continue
        op = m.group(1)
        cur["instructions"] += 1
        if op.startswith("IMAD"):
            cur["imad"] += 1
            if not op.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")):
                cur["imad_mul"] += 1
    return counts


def kernel_function(record):
    """The CUDA kernel function of a kernel record ("point_add_g1" ->
    "point_add_kernel", "point_add_g2" -> "point_add_g2_kernel")."""
    base = record.builds[min(record.builds)].name
    return re.sub(r"_g1$", "", base) + "_kernel"


class StageTimes(logging.Handler):
    """Collects the `took_s` of the package's timed log events.  With
    `memory` (`--c3`, `--c4`), also the card's memory as each event ends
    (`mem[name]`, GiB: allocated, reserved, and the peak since the
    previous event, whose counter it resets), so that a prove's peak is
    split by stage; `peak_gib` is then the peak since `reset`."""

    def __init__(self, memory=False):
        super().__init__()
        self.took = {}
        self.mem = {} if memory else None
        self._peak = 0.0

    def emit(self, record):
        kv = getattr(record, "kv", None) or {}
        if "took_s" not in kv:
            return
        name = record.getMessage()
        self.took[name] = kv["took_s"]
        if self.mem is not None:
            import torch

            peak = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            self._peak = max(self._peak, peak)
            self.mem[name] = {
                "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                "reserved_gib": torch.cuda.memory_reserved() / 2**30,
                "peak_gib": max(peak, self.mem.get(name, {}).get(
                    "peak_gib", 0.0))}

    def reset(self):
        """Forget the events and start the card's peak counter anew."""
        import torch

        self.took.clear()
        if self.mem is not None:
            self.mem.clear()
        self._peak = 0.0
        torch.cuda.reset_peak_memory_stats()

    def peak_gib(self):
        import torch

        return max(self._peak, torch.cuda.max_memory_allocated() / 2**30)


def host_points(spec, k, rng):
    """k distinct random host points: a random point and the sums of a
    random step, k - 1 host adds in place of k scalar multiplications
    (tens of seconds at BW6-761's 761 bits)."""
    pt = spec.gen.mul(rng.randrange(1, spec.r))
    step = spec.gen.mul(rng.randrange(1, spec.r))
    out = [pt]
    for _ in range(k - 1):
        out.append(out[-1].add(step))
    return out


def random_points(dc, spec, k, rng):
    """k*k random points in projective form: the host makes k points
    (`host_points`), the card adds every pair with the plain composition
    (random Z)."""
    import torch

    from davinci_tpu_torch.ec import cuda_add

    base = dc.encode_points(host_points(spec, k, rng))
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


B1_SIZES = (22, 22 * 2048, 1 << 16)  # the combine's, the merge's, 2^16


def b1_phase(dev, name, k=256, tag="[2]"):
    """B1 (the build for the curve's L) against its plain version on k*k
    random sums plus the edge and near-p cases, on limb-major planes and
    through the row wrapper (`DeviceCurve.add`); a few results and every
    hard case against host arithmetic.  Event, device and plain times and
    the bound on planes at each n of B1_SIZES, and through the rows at
    2^16.  Returns {"planes": {n: result}, "rows": result}."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.ec import cuda_add, get_device_curve

    spec = getattr(C, name)
    dc = get_device_curve(spec, dev)
    kernel = K.B1.at(dc.df.L)
    rng = random.Random(SEED + 2)
    pts, _ = random_points(dc, spec, k, rng)
    hard_p, hard_q = hard_cases(dc, host_points(spec, 32, rng))
    shift = rng.randrange(1, k * k)
    other = tuple(torch.roll(a, shift, 0) for a in pts)
    P = tuple(torch.cat(c) for c in zip(pts, hard_p))
    Q = tuple(torch.cat(c) for c in zip(other, hard_q))
    planes = lambda t: tuple(a.T.contiguous() for a in t)
    want = cuda_add.rcb15_plain(dc, P, Q)
    err = max(max_err(dc.add(P, Q), want),
              max_err(cuda_add.point_add_planes(dc, planes(P), planes(Q)),
                      planes(want)))
    torch.cuda.synchronize()
    check(err == 0, f"{kernel.name} differs from its plain version on {name}")
    n = k * k
    idx = [rng.randrange(n) for _ in range(4)] + list(range(n, P[0].shape[0]))
    sel = lambda t: tuple(a[idx] for a in t)
    host = [a.add(b) for a, b in zip(dc.decode_points(sel(P)),
                                      dc.decode_points(sel(Q)))]
    check(dc.decode_points(sel(want)) == host, f"{kernel.name} vs host add")
    L = dc.df.L
    out = {"planes": {}}
    for m in B1_SIZES:
        a, b = planes(tuple(x[:m] for x in pts)), planes(
            tuple(x[:m] for x in other))
        run = lambda: cuda_add.point_add_planes(dc, a, b)
        bound_ms, bound_by = bound(9 * m * L * 4, m, "add", L)
        out["planes"][m] = {
            "n": m, "checked": P[0].shape[0], "max_abs_err": err,
            "ms": cuda_ms(run, 20),
            "device_ms": device_ms(run, 20, "point_add_kernel"),
            "plain_ms": cuda_ms(lambda: cuda_add.rcb15_plain(
                dc, tuple(x.T for x in a), tuple(x.T for x in b)), 3),
            "bound_ms": bound_ms, "bound_by": bound_by}
        say(f"{tag} {name} {kernel.name} on planes {out['planes'][m]}")
    run = lambda: dc.add(pts, other)
    bound_ms, bound_by = bound(9 * n * L * 4, n, "add", L)
    out["rows"] = {"n": n, "ms": cuda_ms(run, 20),
                   "device_ms": device_ms(run, 20, "point_add_rows_kernel"),
                   "bound_ms": bound_ms, "bound_by": bound_by}
    say(f"{tag} {name} {kernel.name} through the rows {out['rows']}")
    return out


def near_p(dc, pts):
    """`pts` rescaled projectively by lambda in Fp so that (the c0 limbs
    of) Z, X or Y are p - 1 in Montgomery form (lambda = -R^-1,
    -R^-1 / x0, -R^-1 / y0); G1 or G2."""
    p = dc.spec.field_spec.p
    Rinv = pow(1 << (12 * dc.df.L), -1, p)
    g2 = dc.ops.coord_ndim == 2
    c0 = (lambda v: v[0]) if g2 else (lambda v: v)
    scaled = ((lambda lam, v: (lam * v[0] % p, lam * v[1] % p)) if g2
              else (lambda lam, v: lam * v % p))

    def rescaled(scale):
        lams = [-Rinv * scale(pt) % p for pt in pts]
        coords = ([pt.x.v for pt in pts], [pt.y.v for pt in pts],
                  [(1, 0) if g2 else 1] * len(pts))
        return tuple(dc.ops.encode([scaled(lam, a)
                                    for lam, a in zip(lams, coord)])
                     for coord in coords)

    return (rescaled(lambda pt: 1),
            rescaled(lambda pt: pow(c0(pt.x.v), -1, p)),
            rescaled(lambda pt: pow(c0(pt.y.v), -1, p)))


def hard_cases(dc, hosts):
    """(P, Q) pairs of the host points: O + B, B + O, B + B, B + (-B),
    O + O, then sums of rescaled points near p - 1, two representations of
    one point, and P + (-P) among them."""
    import torch

    base = dc.encode_points(hosts)
    el, er = edge_cases(dc, base)
    nz, nx, ny = near_p(dc, hosts)
    roll = lambda pt: tuple(torch.roll(c, 7, 0) for c in pt)
    lhs = (el, nz, nx, ny, nz, nx)
    rhs = (er, roll(nx), roll(ny), roll(nz), nx, dc.neg(ny))
    cat = lambda pts: tuple(torch.cat([pt[c] for pt in pts]) for c in range(3))
    return cat(lhs), cat(rhs)


def g2_add_phase(dev, names=G2_CURVES, sizes=G2_SIZES, k=64):
    """B7 against its plain version for each G2 curve of `names` at each n
    of `sizes`: sums of two of k random host points (random Z) and, at
    every n, the edge and near-p cases; a few results and every edge case
    of the first n against host arithmetic.  Returns {curve: {n: result}}."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.ec import cuda_add, get_device_curve

    rng = random.Random(SEED + 3)
    out = {}
    for name in names:
        spec = getattr(C, name)
        dc = get_device_curve(spec, dev)
        kernel = K.B7.at(dc.df.L)
        hosts = [spec.gen.mul(rng.randrange(1, spec.r)) for _ in range(k)]
        base = dc.encode_points(hosts)
        hard_p, hard_q = hard_cases(dc, hosts)
        out[name] = {}
        for n in sizes:
            i = torch.arange(n, device=dev)
            Pn = cuda_add.rcb15_plain(dc, tuple(a[i % k] for a in base),
                                      tuple(a[(i // k) % k] for a in base))
            Qn = tuple(torch.roll(a, 3, 0) for a in Pn)
            P = tuple(torch.cat(c) for c in zip(Pn, hard_p))
            Q = tuple(torch.cat(c) for c in zip(Qn, hard_q))
            got = dc.add(P, Q)  # on a CUDA tensor: the kernel
            err = max_err(got, cuda_add.rcb15_plain(dc, P, Q))
            torch.cuda.synchronize()
            check(err == 0, f"{kernel.name} differs from its plain version "
                            f"on {name} at n={n}")
            if n == sizes[0]:
                idx = list(range(n)) + list(range(n, P[0].shape[0]))
                sel = lambda t: tuple(a[idx] for a in t)
                host = [a.add(b) for a, b in zip(dc.decode_points(sel(P)),
                                                  dc.decode_points(sel(Q)))]
                check(dc.decode_points(sel(got)) == host,
                      f"{kernel.name} vs host add on {name}")
            ms = cuda_ms(lambda: dc.add(Pn, Qn), 20)
            dev_ms = device_ms(lambda: dc.add(Pn, Qn), 20, "point_add")
            plain_ms = cuda_ms(lambda: cuda_add.rcb15_plain(dc, Pn, Qn), 3)
            bound_ms, bound_by = bound(9 * n * 2 * dc.df.L * 4, n, "add_g2",
                                       dc.df.L)
            out[name][n] = {
                "kernel": kernel.name, "n": n,
                "checked": P[0].shape[0], "max_abs_err": err, "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
            say(f"[3] {name} {out[name][n]}")
    return out


def g2_msm_phase(dev, rng_np):
    """A 4,096-point BLS12-377 G2 MSM through `msm` (the fused route, B7
    and B5's G2 build at L = 32) against the host oracle; their launches
    in it, and the arguments of its Horner launch."""
    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.msm import msm

    case = tiled_msm_case(dev, rng_np, n=4096, spec=C.bls377_g2)
    K.B7_L32.launches = K.B5G2_L32.launches = 0
    with Capture(("horner_g2_kernel",)) as cap:
        res = msm_phase(msm, case)
    res["launches"] = {k.name: k.launches for k in (K.B7_L32, K.B5G2_L32)}
    for name, count in res["launches"].items():
        check(count > 0, f"the G2 MSM did not launch {name}")
    return res, cap.args


class G2Batches:
    """While installed, counts the G2 point adds by the batch size they
    are launched at."""

    def __enter__(self):
        from davinci_tpu_torch.ec import cuda_add

        self.sizes = {}
        self.saved = cuda_add.point_add_fp2

        def rec(curve, p, q):
            import torch

            shape = torch.broadcast_shapes(p[0].shape, q[0].shape)[:-2]
            n = int(torch.Size(shape).numel())
            self.sizes[n] = self.sizes.get(n, 0) + 1
            return self.saved(curve, p, q)

        cuda_add.point_add_fp2 = rec
        return self

    def __exit__(self, *exc):
        from davinci_tpu_torch.ec import cuda_add

        cuda_add.point_add_fp2 = self.saved


def tiled_msm_case(dev, rng_np, n=1 << 17, spec=None):
    """An MSM (default BN254 G1) of n points tiling 64 distinct bases
    k_b G, with random 12-bit windows, and its host oracle: the per-base
    scalar sums t_b, then (sum_b k_b t_b) G, one host multiplication."""
    import numpy as np
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm.pippenger import NBUCKETS, WINDOW_BITS

    spec = spec or C.bn254_g1
    dc = get_device_curve(spec, dev)
    ks = [int(k) for k in rng_np.integers(1, 2**31, 64)]
    P64 = dc.encode_points([spec.gen.mul(k) for k in ks])
    pts = tuple(a.repeat((n // 64,) + (1,) * (a.dim() - 1)) for a in P64)
    W = -(-spec.r.bit_length() // WINDOW_BITS)
    S = rng_np.integers(0, NBUCKETS, size=(n, W), dtype=np.int32)
    # the top window of a reduced scalar (2 bits at BN254, 3 at BLS12-381)
    S[:, -1] &= (1 << (spec.r.bit_length() - WINDOW_BITS * (W - 1))) - 1
    S64 = S.astype(np.int64)
    acc = 0
    for b in range(64):
        per_window = S64[b::64, :].sum(axis=0)
        total = sum(int(v) << (WINDOW_BITS * j) for j, v in enumerate(per_window))
        acc += ks[b] * total
    return dc, pts, torch.as_tensor(S, device=dev), spec.gen.mul(acc % spec.r)


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


def call_size(args):
    """The tensor elements of a wrapper call's arguments after the curve or
    field."""
    import torch

    return sum(t.numel() for t in flat(args[1:]) if isinstance(t, torch.Tensor))


class Capture:
    """While installed, records the arguments of every call of each
    kernel wrapper named (default: the scan path's B2-B5;
    "point_add_planes" adds B1), so they can be replayed: `calls[name]`
    lists them in order, `args[name]` is the first.  With `largest`, only
    the first call and the largest of the rest (`call_size`), where that
    is larger than the first, are kept, so a path at full size holds one
    or two calls' inputs per wrapper; `counts[name]` is the number of
    calls made either way."""

    WRAPPERS = ("_bucket_scan", "bucket_reduce_kernel",
                "suffix_reduce_kernel", "horner_kernel")
    # every wrapper a Groth16 prove reaches: B1 (rows and planes), B2-B5,
    # B5's G2 build, B6 and B7
    PROVE = WRAPPERS + ("point_add", "point_add_planes", "horner_g2_kernel",
                        "point_add_fp2", "mont_mul")

    def __init__(self, names=WRAPPERS, largest=False):
        self.names, self.largest = names, largest
        self.calls, self.counts = {}, {}

    @property
    def args(self):
        return {name: calls[0] for name, calls in self.calls.items()}

    @staticmethod
    def _module(name):
        from davinci_tpu_torch.ec import cuda_add
        from davinci_tpu_torch.ff import cuda_mul
        from davinci_tpu_torch.msm import bucket_kernel as bk

        if name == "mont_mul":
            return cuda_mul
        return cuda_add if name.startswith("point_add") else bk

    def __enter__(self):
        self.saved = {name: getattr(self._module(name), name)
                      for name in self.names}
        for name, fn in self.saved.items():
            def rec(*args, _name=name, _fn=fn):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                calls = self.calls.setdefault(_name, [])
                if not self.largest or not calls:
                    calls.append(args)
                elif call_size(args) > call_size(calls[-1]):
                    calls[1:] = [args]
                return _fn(*args)
            setattr(self._module(name), name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self._module(name), name, fn)


def b2_work(args):
    """(bytes, mixed adds) of one B2 call: its packed planes, keys and
    streamed accumulators, and the adds the sorted keys ask for (a lane's
    row joins the run of the row before where their buckets agree)."""
    dc, pts_arr, keys_arr, signed = args
    rows, LP, nl = pts_arr.shape
    bucket = (keys_arr >> 1) if signed else keys_arr
    return (rows * nl * (LP + 1 + 3 * dc.df.L) * 4,
            int((bucket[1:] == bucket[:-1]).sum()))


def b1_planes_work(args):
    """(bytes, adds) of one B1 call on (L, ...) planes: two points read,
    one written, an add each."""
    dc, p, _ = args
    n = p[0][0].numel()
    return 9 * n * dc.df.L * 4, n


def b3_work(args):
    """(bytes, adds) of one B3 call on (L, Wt, NB) buckets: the buckets
    read, A and B written (C lanes a window), 2K - 1 adds a lane."""
    dc, buckets = args
    L, Wt, NB = buckets[0].shape
    C = reduce_lanes(NB)
    return (3 * L * Wt * NB + 6 * L * Wt * C) * 4, Wt * C * (2 * (NB // C) - 1)


def reduce_lanes(NB):
    """B3's lanes a window, as `bucket_reduce_kernel` picks them."""
    from davinci_tpu_torch.msm import bucket_kernel as bk

    return bk.REDUCE_C if NB % bk.REDUCE_C == 0 else NB


def b4_work(args):
    """(bytes, adds) of one B4 call on (K, 3L, M) point columns."""
    dc, s = args
    Ks, L3, M = s.shape
    return (Ks + 2) * L3 * M * 4, M * (2 * Ks - 1)


def scan_kernels_phase(calls, regs, tag="[4c]"):
    """B2-B5 (the build for the curve's L) against their plain versions on
    the main path's inputs (`Capture.calls`; B5 at both of its shapes: the
    window sums, its last call, and the reduce's combine, its first, a
    Horner step of two windows): the largest difference, kernel, device
    and plain times, the bound, ptxas's registers and spills (`regs`,
    from `build_phase`)."""
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.msm import bucket_kernel as bk
    from davinci_tpu_torch.msm.pippenger import WINDOW_BITS

    args = {name: c[0] for name, c in calls.items()}
    args["horner_kernel"] = calls["horner_kernel"][-1]
    _, csums, cW, cbits = calls["horner_kernel"][0]
    check(cW == 2 and cbits < WINDOW_BITS, "B5's first call is a combine")
    cB = csums[0].shape[1] // cW
    dc, pts_arr, keys_arr, signed = args["_bucket_scan"]
    rows, LP, nl = pts_arr.shape
    L = dc.df.L
    b2_bytes, mixed_adds = b2_work(args["_bucket_scan"])
    _, buckets = args["bucket_reduce_kernel"]
    _, Wt, NB = buckets[0].shape
    C = reduce_lanes(NB)
    _, s = args["suffix_reduce_kernel"]
    Ks, _, M = s.shape
    T = bk.suffix_chunk(Ks)
    _, sums, W, wbits = args["horner_kernel"]
    B = sums[0].shape[1] // W
    check(wbits == WINDOW_BITS, "Horner's doublings per window")
    word = 4
    b5 = K.B5.at(L)
    table = [
        (K.B2.at(L), lambda: bk._bucket_scan(dc, pts_arr, keys_arr, signed),
         lambda: bk._bucket_scan_plain(dc, pts_arr, keys_arr, signed),
         b2_bytes, mixed_adds, "mixed",
         {"rows": rows, "lanes": nl}),
        (K.B3.at(L), lambda: bk.bucket_reduce_kernel(dc, buckets),
         lambda: bk._bucket_reduce_plain(dc, buckets, C),
         *b3_work(args["bucket_reduce_kernel"]), "add",
         {"Wt": Wt, "NB": NB, "C": C}),
        (K.B4.at(L), lambda: bk.suffix_reduce_kernel(dc, s),
         lambda: bk._suffix_reduce_split_plain(dc, s, T),
         *b4_work(args["suffix_reduce_kernel"]), "add",
         {"K": Ks, "M": M, "T": T}),
        (b5, lambda: bk.horner_kernel(dc, sums, W, wbits),
         lambda: bk._horner_plain(dc, sums, W, wbits),
         3 * L * (W + 1) * B * word, B * (W - 1) * (wbits + 1), "add",
         {"W": W, "B": B, "wbits": wbits}),
        (b5, lambda: bk.horner_kernel(dc, csums, cW, cbits),
         lambda: bk._horner_plain(dc, csums, cW, cbits),
         3 * L * (cW + 1) * cB * word, cB * (cW - 1) * (cbits + 1), "add",
         {"W": cW, "B": cB, "wbits": cbits, "combine": True}),
    ]
    res = {}
    for kernel, run, plain, nbytes, adds, kind, shape in table:
        name = kernel.name + ("_combine" if shape.get("combine") else "")
        got = run()
        want, plain_ms = timed_call(plain)
        err = max_err(got, want)
        check(err == 0, f"{kernel.name} differs from its plain version")
        if kernel.builds[22] is K.B4:  # split order: the reference's points
            cols = lambda t: tuple(t[c * L:(c + 1) * L].T for c in range(3))
            for g, w in zip(got, bk._suffix_reduce_plain(dc, s)):
                check(dc.decode_points(cols(g)) == dc.decode_points(cols(w)),
                      f"{kernel.name}: other points than the reference order")
        ms = cuda_ms(run, 5)
        bound_ms, bound_by = bound(nbytes, adds, kind, L)
        rec = res[name] = {**shape, "adds": adds, "max_abs_err": err,
                           "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by}
        rec["device_ms"] = device_ms(run, 20, kernel_function(kernel))
        rec["ptxas"] = regs[f"{kernel_function(kernel)}@L{L}"]
        if kernel is b5:  # its chain: one dependent add at a time
            rec["chain_adds"] = (shape["W"] - 1) * (shape["wbits"] + 1)
            rec["us_per_add"] = ms * 1e3 / rec["chain_adds"]
        say(f"{tag} {name} {rec}")
    return res


def g2_horner_phase(args, tag):
    """B5's G2 build (the build for the curve's L) against its plain
    version on the window sums a G2 MSM gave it: the largest difference,
    event and device times, the plain time, the bound, the chain's
    microseconds per dependent add (by events: one launch of several
    milliseconds, whose profiler time can miss records)."""
    from davinci_tpu_torch.msm import bucket_kernel as bk

    dc, sums, wbits = args["horner_g2_kernel"]
    W, B = sums[0].shape[:2]
    L = dc.df.L
    kernel = bk.B5G2.at(L)
    run = lambda: bk.horner_g2_kernel(dc, sums, wbits)
    plain = lambda: bk._horner_rows_plain(dc, sums, wbits)
    want, plain_ms = timed_call(plain)
    err = max_err(run(), want)
    check(err == 0, f"{kernel.name} differs from its plain version")
    chain = (W - 1) * (wbits + 1)
    ms = cuda_ms(run, 5)
    dev_ms = device_ms(run, 20, "horner_g2_kernel")
    bound_ms, bound_by = bound(3 * 2 * L * (W + 1) * B * 4, B * chain,
                               "add_g2", L)
    out = {"curve": dc.spec.name, "W": W, "B": B, "chain_adds": chain,
           "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "us_per_add": ms * 1e3 / chain, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    say(f"{tag} {kernel.name} {out}")
    return kernel.name, out


def captured_add_phase(args):
    """B1 (the build for the curve's L) against its plain version on the
    first point add a main path ran (the scan path's planes)."""
    import torch

    from davinci_tpu_torch.ec import cuda_add

    dc, p, q = args["point_add_planes"]
    kernel = cuda_add.B1.at(dc.df.L)
    run = lambda: cuda_add.point_add_planes(dc, p, q)
    rows = lambda t: tuple(a.reshape(a.shape[0], -1).T for a in t)
    plain = lambda: cuda_add.rcb15_plain(dc, rows(p), rows(q))
    got = run()
    torch.cuda.synchronize()
    err = max_err(rows(got), plain())
    check(err == 0, f"{kernel.name} differs from its plain version")
    n = p[0][0].numel()
    bound_ms, bound_by = bound(*b1_planes_work(args["point_add_planes"]),
                               "add", dc.df.L)
    return kernel.name, {"n": n, "max_abs_err": err, "ms": cuda_ms(run, 20),
                         "device_ms": device_ms(run, 20, "point_add_kernel"),
                         "plain_ms": cuda_ms(plain, 3), "bound_ms": bound_ms,
                         "bound_by": bound_by}


def replay_phase(cap, tag):
    """Every call a path kept of each kernel wrapper (`Capture.calls`: all
    of them, or the first and the largest) made again, against its plain
    version on the same inputs: each must be equal, limb for limb.  Per
    wrapper: the calls made and replayed, the largest difference, and the
    kernel's and the plain version's ms on the largest call (CUDA
    events)."""
    from davinci_tpu_torch.ec import cuda_add
    from davinci_tpu_torch.ff import cuda_mul
    from davinci_tpu_torch.msm import bucket_kernel as bk

    def rows(t):
        return tuple(a.reshape(a.shape[0], -1).T for a in t)

    def planes_plain(dc, p, q):
        out = cuda_add.rcb15_plain(dc, rows(p), rows(q))
        return tuple(a.T.reshape(p[0].shape) for a in out)

    def reduce_plain(dc, buckets):
        return bk._bucket_reduce_plain(dc, buckets,
                                       reduce_lanes(buckets[0].shape[2]))

    def suffix_plain(dc, s):
        return bk._suffix_reduce_split_plain(dc, s, bk.suffix_chunk(s.shape[0]))

    plains = {"point_add": cuda_add.rcb15_plain,
              "point_add_planes": planes_plain,
              "point_add_fp2": cuda_add.rcb15_plain,
              "_bucket_scan": bk._bucket_scan_plain,
              "bucket_reduce_kernel": reduce_plain,
              "suffix_reduce_kernel": suffix_plain,
              "horner_kernel": bk._horner_plain,
              "horner_g2_kernel": bk._horner_rows_plain,
              "mont_mul": cuda_mul.mont_mul_plain}

    res = {}
    for name, made in cap.calls.items():
        kernel, plain = getattr(Capture._module(name), name), plains[name]
        big = max(made, key=call_size)
        err = 0
        for args in made:
            got = flat(kernel(*args))
            want, ms = timed_call(lambda: plain(*args))
            want = flat(want)
            if args is big:
                plain_ms = ms
            check(len(got) == len(want) and all(
                g.shape == w.shape for g, w in zip(got, want)),
                f"{name}: other shapes than its plain version's")
            if any(g.numel() for g in got):
                err = max(err, max_err(got, want))
        check(err == 0, f"{name} differs from its plain version on a call "
                        f"of the path")
        res[name] = {"calls": cap.counts[name], "replayed": len(made),
                     "max_abs_err": err, "largest": call_size(big),
                     "ms": cuda_ms(lambda: kernel(*big), 3),
                     "plain_ms": plain_ms}
        say(f"{tag} {name} {res[name]}")
    return res


def ballot_circuit():
    """The full-size ballot-proof circuit (c1) with the inputs of the
    reference's benchmark, built by the package's host copy.  Returns (the
    system, its public inputs hash, the build's seconds, the ballot's
    witness, the election's private key)."""
    from davinci_tpu_torch.ballotmode import BallotMode
    from davinci_tpu_torch.circuits.ballotproof import (
        build_ballot_proof_circuit,
        make_ballot,
    )
    from davinci_tpu_torch.elgamal import generate_key

    t0 = time.perf_counter()
    rng = random.Random(0xF3)
    pub, priv = generate_key(rng)
    bw = make_ballot(
        12345, BallotMode(), (pub.x, pub.y), rng.randrange(2**160),
        rng.randrange(1, 2**200), [1, 0, 0, 0, 0, 0, 0, 0],
    )
    cs = build_ballot_proof_circuit(bw)
    build_s = time.perf_counter() - t0
    check(len(cs.constraints) == 99946, "c1 constraint count")
    say(f"[5] c1 built: {len(cs.constraints)} constraints, "
        f"{cs.num_variables} variables in {build_s:.3f} s")
    return cs, [bw.inputs_hash()], build_s, bw, priv


def mont_mul_phase(dev, n=1 << 16, names=B6_FIELDS, tag="[6]"):
    """B6 against its plain version for each field of `names`:
    random elements, 0, 1, p - 1, and raw values up to R - 1 through
    to_mont on either side; kernel and plain times on the random pairs."""
    import numpy as np
    import torch

    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.ff import cuda_mul, get_device_field

    res = {}
    rng = random.Random(SEED + 6)
    for name in names:
        spec = getattr(F, name)
        df = get_device_field(spec, dev)
        L, p = df.L, spec.p
        kernel = K.B6.at(L)

        def draw(bound, k):
            return [rng.getrandbits(12 * L) % bound for _ in range(k)]

        xs = draw(p, n - 3) + [0, 1, p - 1]
        ys = draw(p, n - 3) + [p - 1, 0, 1]
        raw = draw(1 << (12 * L), 1021) + [(1 << (12 * L)) - 1, p, 0]
        a, b = df.encode(xs), df.encode(ys)
        c = torch.as_tensor(
            np.array([[(v >> (12 * j)) & 0xFFF for j in range(L)] for v in raw],
                     np.int32), device=dev)
        err = 0
        for x, y in ((a, b), (c, b[:1024]), (b[:1024], c), (a, b[:1]),
                     (a, b[0]), (a[1:], b[:-1]),
                     (a.reshape(2, n // 2, L), b[:n // 2])):
            err = max(err, max_err(cuda_mul.mont_mul(df, x, y),
                                   cuda_mul.mont_mul_plain(df, x, y)))
        torch.cuda.synchronize()
        check(err == 0, f"{kernel.name} differs from its plain version "
                        f"on {name}")
        spot = list(range(3)) + [n - 3, n - 2, n - 1]
        check(df.decode(df.mul(a[spot], b[spot]))
              == [xs[i] * ys[i] % p for i in spot], f"{name} vs host")
        check(df.decode(df.to_mont(c[-4:])) == [v % p for v in raw[-4:]],
              f"{name} to_mont vs host")
        ms = cuda_ms(lambda: cuda_mul.mont_mul(df, a, b), 20)
        dev_ms = device_ms(lambda: cuda_mul.mont_mul(df, a, b), 20,
                           "mont_mul_kernel")
        host_us = host_us_per_call(lambda: cuda_mul.mont_mul(df, a, b))
        plain_ms = cuda_ms(lambda: cuda_mul.mont_mul_plain(df, a, b), 3)
        bound_ms, bound_by = bound(3 * n * L * 4, n, "mul", L)
        res[name] = {"kernel": kernel.name, "n": n, "max_abs_err": err,
                     "ms": ms, "device_ms": dev_ms, "host_us": host_us,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        say(f"{tag} {name} {res[name]}")
    return res


def synthetic_batch(rng, n_votes):
    """A batch with the attributes `pack_batch_blob` reads (results and
    re-encrypted ballots of FIELDS_PER_BALLOT * 4 coordinates each)."""
    from types import SimpleNamespace

    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.state.blobcodec import COORDS

    def ballot():
        vals = [rng.randrange(F.BN254_R) for _ in range(COORDS)]
        return SimpleNamespace(coords=lambda: list(vals))

    votes = [SimpleNamespace(vote_id=rng.randrange(F.BN254_R),
                             address=rng.randrange(2**160),
                             ballot_index=rng.randrange(2**32),
                             weight=rng.randrange(1, 2**64),
                             reencrypted_ballot=ballot())
             for _ in range(n_votes)]
    return SimpleNamespace(new_results=ballot(), voters_count=n_votes,
                           votes=votes, root_before=rng.randrange(F.BN254_R))


def blob_phase(dev, kernels, rng, rng_np, regs):
    """The blob path (phase 7); returns (summary, {kernel: result})."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import spec
    from davinci_tpu_torch.blobs import kzg
    from davinci_tpu_torch.blobs.setup import load_trusted_setup
    from davinci_tpu_torch.msm import pippenger
    from davinci_tpu_torch.state.blobcodec import pack_batch_blob

    out = {}
    t0 = time.perf_counter()
    g1_brp, _ = load_trusted_setup()
    out["setup_load_s"] = time.perf_counter() - t0
    batch = synthetic_batch(rng, spec.VOTES_PER_BATCH)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    packed = pack_batch_blob(0xB10B, batch, with_kzg=True)
    torch.cuda.synchronize()
    out["pack_s"] = time.perf_counter() - t0
    out["launches"] = {k.name: k.launches for k in kernels}
    for k in kernels:
        check(k.launches > 0, f"{k.name} was not launched by the blob path")
    check(packed["n_cells"] == 33 + 60 * 36, "blob cells")
    com, proof = (bytes.fromhex(packed[key]) for key in ("commitment",
                                                          "kzg_proof"))
    z, y = packed["z"], packed["y"]
    t0 = time.perf_counter()
    check(kzg.verify_kzg_proof(com, z, y, proof), "KZG proof does not verify")
    out["verify_s"] = time.perf_counter() - t0
    check(not kzg.verify_kzg_proof(com, z, (y + 1) % kzg.R, proof),
          "KZG proof verifies with y + 1")
    say(f"[7] 60-vote blob: {packed['n_cells']} cells, commitment "
        f"{packed['commitment'][:16]}..., proof verifies, y + 1 refused; "
        f"{out}")

    cells = [rng.randrange(kzg.R) for _ in range(5)]
    want = C.bls381_g1.infinity()
    for c, g in zip(cells, g1_brp):
        want = want.add(g.mul(c))
    check(kzg.blob_to_commitment(kzg.Blob(cells)) == kzg.compress_g1(want),
          "sparse blob commitment differs from the host oracle")

    case = tiled_msm_case(dev, rng_np, n=kzg.BLOB_CELLS, spec=C.bls381_g1)
    with Capture(Capture.WRAPPERS + ("point_add_planes",)) as cap:
        out["msm"] = msm_phase(pippenger._msm_scan, case)
    check(sorted(cap.calls) == sorted(cap.names), "B1-B5 recorded")
    say(f"[7] sparse blob commitment and the tiled 4,096-point BLS12-381 "
        f"MSM equal their host oracles: {out['msm']}")
    name, add = captured_add_phase(cap.args)
    say(f"[7] {name} {add}")
    res = {name: add, **scan_kernels_phase(cap.calls, regs, "[7]")}
    return out, res


def addk_phase(dev, sizes=ADDK_SIZES):
    """Phase 8: the point-add experiment's entry path, then each B8
    variant against its plain version and B1 at each n of `sizes`;
    returns ({kernel name: result at the experiment's n}, {variant:
    launches})."""
    import torch

    from davinci_tpu_torch import cuda_build
    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.ec import addk_exp, cuda_add, get_device_curve

    dc = get_device_curve(C.bn254_g1, dev)
    iters = 30
    n0 = ADDK_SIZES[0]
    pts, a, b = addk_exp.experiment_points(dc, n0)
    for k in K.B8.values():
        k.launches = 0
    for v in addk_exp.KERNELS:
        addk_exp.run_variant(v, dc, a, b, pts, n0, iters)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in K.B8.values()}
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the experiment")
    say(f"[8] the experiment's run_variant, every variant at n={n0}: "
        f"launches {launches}")
    lib = cuda_build.library_path(Path(K.B8["v2d"].source).stem, 22)
    sass = {f: c for f, c in sass_counts(lib).items() if f.startswith("addk_")}
    say(f"[8] cuobjdump -sass per add (one add a thread): {sass}")

    res = {}
    for n in sizes:
        pts, a, b = addk_exp.experiment_points(dc, n)
        hard_a, hard_b = addk_exp.hard_cases(dc, pts)
        rows_a = tuple(torch.cat(c) for c in zip(a, hard_a))
        rows_b = tuple(torch.cat(c) for c in zip(b, hard_b))
        A = tuple(x.T.contiguous() for x in rows_a)
        B = tuple(x.T.contiguous() for x in rows_b)
        b1 = tuple(x.T for x in dc.add(rows_a, rows_b))
        an = tuple(x.T.contiguous() for x in a)
        bn = tuple(x.T.contiguous() for x in b)
        nbytes = 9 * dc.df.L * 4 * n

        def chain(add, o, q):
            for _ in range(iters):
                o = add(o, q)

        out = {}
        for v in addk_exp.KERNELS:
            kernel = K.B8[v]
            got = addk_exp.add_2d(dc, v, *A, *B)
            err = max_err(got, addk_exp.add_2d_plain(dc, v, *A, *B))
            check(err == 0, f"{kernel.name} differs from its plain version "
                            f"at n={n}")
            if v != "addonly":
                check(max_err(got, b1) == 0, f"{kernel.name} differs from B1 "
                                             f"at n={n}")
            ms = addk_exp.run_variant(v, dc, a, b, pts, n, iters)
            add = lambda o, q, v=v: addk_exp.add_2d(dc, v, *o, *q)
            dev_ms = device_ms(lambda: chain(add, an, bn), 1,
                               f"addk_{v}_kernel")
            plain_ms = cuda_ms(
                lambda: addk_exp.add_2d_plain(dc, v, *an, *bn), 1, warm=False)
            bound_ms, bound_by = bound(nbytes, 0 if v == "addonly" else n,
                                       "add")
            out[kernel.name] = {
                "n": n, "checked": A[0].shape[1], "max_abs_err": err,
                "ms": ms, "device_ms": dev_ms and dev_ms / iters,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
            say(f"[8] {kernel.name} {out[kernel.name]}")
        b1 = lambda o, q: cuda_add.point_add_planes(dc, o, q)
        ms = cuda_ms(lambda: chain(b1, an, bn), 1) / iters
        dev_ms = device_ms(lambda: chain(b1, an, bn), 1, "point_add_kernel")
        say(f"[8] B1 on the same planes, a {iters}-launch chain: {{'n': {n}, "
            f"'ms': {ms}, 'device_ms': {dev_ms and dev_ms / iters}}}")
        if n == n0:
            res = out
    return res, launches


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
    with G2Batches() as g2, Capture(("horner_g2_kernel",)) as cap:
        proof = g16.prove(pk, cs, r_rand=7, s_rand=11)
    out["prove_first_s"] = time.perf_counter() - t0
    out["prove_launches"] = {k.name: k.launches for k in kernels}
    out["prove_g2_adds_by_n"] = dict(sorted(g2.sizes.items()))
    out["stages_first_s"] = dict(stages.took)
    for k in kernels:
        check(k.launches > 0, f"{k.name} was not launched by the prove")
    check(1 not in g2.sizes, "the prove made G2 adds of one point")
    out["horner_g2_args"] = cap.args
    out["proof"], out["vk"] = proof, vk  # c2's inner proof (phase 10)
    out["key"] = (g16, pk, cs, public)  # phase 15's sharded prove
    t0 = time.perf_counter()
    check(g16.verify(vk, proof, public), "proof does not verify")
    out["verify_s"] = time.perf_counter() - t0
    check(not g16.verify(vk, proof, [public[0] + 1]),
          "proof verifies against a wrong public input")
    say(f"[5] prove: {out['prove_first_s']:.3f} s, verify true in "
        f"{out['verify_s']:.3f} s, launches {out['prove_launches']}, "
        f"G2 adds by batch size {out['prove_g2_adds_by_n']}")

    stages.took.clear()
    msm_s = {"g1": [], "g2": []}
    real_msm = g16._msm_enc

    def timed_msm(dc, *args):  # each MSM ends in a host decode
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_msm(dc, *args)
        msm_s["g2" if dc.ops.coord_ndim == 2 else "g1"].append(
            time.perf_counter() - t)
        return res

    g16._msm_enc = timed_msm
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    proof2 = g16.prove(pk, cs)
    out["prove_s"] = time.perf_counter() - t0
    del g16._msm_enc
    # the steady prove's: the NTT's tables are built by the first one
    out["steady_launches"] = {k.name: k.launches for k in kernels}
    for k in kernels:
        check(k.launches > 0, f"{k.name} was not launched by the steady prove")
    say("[5] launches per prove of B1, B5 and B6, first / steady: "
        + ", ".join(f"{name} {out['prove_launches'][name]} / "
                    f"{out['steady_launches'][name]}"
                    for name in ("point_add_g1", "horner_g1", "mont_mul")))
    out["stages_s"] = dict(stages.took)
    out["msm_g1_s"], out["msm_g2_s"] = msm_s["g1"], msm_s["g2"]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    check(g16.verify(vk, proof2, public), "second proof does not verify")
    say(f"[5] timed prove: {out['prove_s']:.3f} s, stages {out['stages_s']}, "
        f"G1 MSMs {out['msm_g1_s']} s, G2 MSM {out['msm_g2_s']} s, "
        f"peak device memory {out['peak_mem_gb']:.2f} GiB")
    return out


COMMITTED_CHAIN = 620     # products: 99,436 constraints, a 2^17 domain
COMMITTED_CHAIN_C2 = 23000  # 3.39M constraints, a 2^22 domain (c2's)
BLS381_CHAIN = 4000       # products of phase 9f: 4,001 constraints, 2^12
# the kernels a BLS12-377 committed prove launches: the G1 MSMs at L = 32
# (B1-B5), the b2 MSM (B7 and the G2 combine at L = 32), every Fr product
# of the witness and the NTT (B6 at L = 22)
COMMITTED_KERNELS = ("point_add_g1_l32", "bucket_scan_g1_l32",
                     "bucket_reduce_g1_l32", "suffix_reduce_g1_l32",
                     "horner_g1_l32", "horner_g2_l32", "mont_mul",
                     "point_add_g2_l32")
# the timed stages of a committed prove (log events)
COMMITTED_STAGES = ("groth16.commit", "groth16.refinalize",
                    "groth16.witness_reduce_dev", "groth16.quotient_ntt",
                    "groth16.msms")


def committed_377(chain, challenge=0, blind=0):
    """committed-377: the arithmetic of the vote verifier (c2) on its curve.
    One public input (7), a chain of `chain` emulated BN254 Fp products
    whose limbs are range-checked by log-derivative lookups (a 2^12 table)
    under the commitment extension, the chain's result asserted equal to
    the host's; the `_refinalize` hook set, so a committed prove builds
    once.  The construction of tests/test_lookup.py:78-131."""
    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.circuits.emulated import EmulatedOps
    from davinci_tpu_torch.circuits.lookup import LookupRangeChecker
    from davinci_tpu_torch.groth16 import ConstraintSystem

    cs = ConstraintSystem(F.BLS12_377_R)
    marker = cs.pub_input(7)
    rc = LookupRangeChecker(cs, table_bits=12)
    E = EmulatedOps(cs, F.BN254_P, range_checker=rc)
    a0, b0 = 123456789, 987654321
    acc, b = E.alloc(a0), E.alloc(b0)
    for _ in range(chain):
        acc = E.mul(acc, b)
    E.assert_eq(acc, E.constant(a0 * pow(b0, chain, F.BN254_P) % F.BN254_P))
    rc.finalize(challenge, blind)
    cs._refinalize = rc.refinalize
    cs.assert_eq(marker, cs.constant(7))
    return cs


def committed_phase(dev, stages, chain=COMMITTED_CHAIN, steady=1):
    """Phase 9: the sequencer's per-vote prover on the port's own modules.
    committed-377 set up on the card through the artifact store (under
    build/, removed at the end), a first committed prove (one build), its
    refusals, the solved system saved and loaded, `steady` reuse proves
    with their stages and launches, and a second store on the same
    directory that loads with no setup.  Returns (results, the runtime,
    the loaded solved system)."""
    import tempfile

    import torch

    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.circuits.artifacts import ArtifactStore
    from davinci_tpu_torch.groth16 import CommittedProof

    cid, out = "committed-377", {}
    t0 = time.perf_counter()
    cs = committed_377(chain)
    out["build_s"] = time.perf_counter() - t0
    out.update(constraints=len(cs.constraints), variables=cs.num_variables,
               committed=len(cs.committed))
    say(f"[9a] committed-377 built: {out['constraints']} constraints, "
        f"{out['variables']} variables, {out['committed']} committed wires "
        f"in {out['build_s']:.3f} s")

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="store-", dir=ROOT / "build"))
    try:
        for k in K.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        rt = ArtifactStore(root).load_or_setup(cid, "bls12_377", cs)
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t0
        out["pk_bin_bytes"] = (root / cid / "pk.bin").stat().st_size
        out["vk_bin_bytes"] = (root / cid / "vk.bin").stat().st_size
        check(rt.g16.device.type == "cuda", "the store's Groth16 is on the card")
        out["setup_launches"] = {k.name: k.launches for k in K.KERNELS
                                 if k.launches}
        say(f"[9b] setup on the card through the store: {out['setup_s']:.3f} "
            f"s, pk.bin {out['pk_bin_bytes']} B, vk.bin {out['vk_bin_bytes']}"
            f" B, launches {out['setup_launches']}")
        del cs

        built = []

        def build(challenge, blind):
            built.append(committed_377(chain, challenge, blind))
            return built[-1]

        t0 = time.perf_counter()
        proof = rt.prove_and_verify_committed(build, [7])
        out["first_prove_and_verify_s"] = time.perf_counter() - t0
        check(len(built) == 1, "the committed prove built the circuit once")
        cs = built[0]
        t0 = time.perf_counter()
        check(not rt.verify_committed(proof, [8]),
              "a committed proof verifies against a wrong public input")
        out["verify_false_s"] = time.perf_counter() - t0
        swapped = CommittedProof(a=proof.a, b=proof.b, c=proof.c, d=proof.d,
                                 pok=proof.d)
        check(not rt.verify_committed(swapped, [7]),
              "a committed proof verifies with its pok replaced by D")
        say(f"[9c] first committed prove and verify "
            f"{out['first_prove_and_verify_s']:.3f} s (one build); false for "
            f"public 8 ({out['verify_false_s']:.3f} s) and for pok = D")

        t0 = time.perf_counter()
        path = ArtifactStore(root).save_solved(cid, "vote", cs)
        lo = ArtifactStore(root).load_solved(cid, "vote")
        out["solved_bytes"] = path.stat().st_size
        out["save_load_solved_s"] = time.perf_counter() - t0
        check(lo is not None and getattr(lo, "_refinalize", None) is not None,
              "the solved system loads with its refinalize state")
        check(lo.values == cs.values, "the loaded witness is the saved one")
        del cs, built
        out["steady"] = []
        for i in range(steady):
            stages.took.clear()
            for k in K.KERNELS:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            proof = rt.prove_committed_reuse(lo)
            torch.cuda.synchronize()
            rec = {"prove_s": time.perf_counter() - t0,
                   "stages_s": {name: stages.took.get(name)
                                for name in COMMITTED_STAGES},
                   "launches": {k.name: k.launches for k in K.KERNELS
                                if k.name in COMMITTED_KERNELS},
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
            for name, n in rec["launches"].items():
                check(n > 0, f"{name} was not launched by the steady prove")
            t0 = time.perf_counter()
            check(rt.verify_committed(proof, lo.public_values()),
                  f"steady proof {i} does not verify")
            rec["verify_s"] = time.perf_counter() - t0
            out["steady"].append(rec)
            say(f"[9d] steady prove {i}: {json.dumps(rec)}")

        stages.took.clear()
        rt2 = ArtifactStore(root).load_or_setup(cid, "bls12_377", lo)
        # a key that does not read is logged, then set up afresh
        check("artifacts.load" in stages.took
              and "artifacts.setup" not in stages.took,
              "the second store loaded the key with no setup")
        check(rt2.pk.z_g1 == rt.pk.z_g1, "the loaded key is the saved one")
        t0 = time.perf_counter()
        proof = rt2.prove_committed_reuse(lo)
        out["second_store_prove_s"] = time.perf_counter() - t0
        check(rt2.verify_committed(proof, [7]),
              "the second store's proof does not verify")
        say(f"[9e] a second store loaded the key with no setup "
            f"({stages.took['artifacts.load']} s) and proved in "
            f"{out['second_store_prove_s']:.3f} s; verified")
    finally:
        shutil.rmtree(root)
    return out, rt, lo


def committed_kernels_phase(rt, lo):
    """Phase 9d's kernels: one more reuse prove with the first and the
    largest call of each kernel wrapper recorded (verified), then each
    against its plain version (`replay_phase`): B1-B5 and B5's G2 build at
    L = 32, B6 on BLS12-377's Fr, B7 at L = 32, at committed-377's own
    shapes."""
    with Capture(Capture.PROVE, largest=True) as cap:
        proof = rt.prove_committed_reuse(lo)
    check(rt.verify_committed(proof, lo.public_values()),
          "the recorded proof does not verify")
    # B1's rows serve setup and the fused route, which a prove may not reach
    missing = set(cap.names) - set(cap.calls) - {"point_add"}
    check(not missing, f"the prove called no {sorted(missing)}")
    return replay_phase(cap, "[9d]")


def bls381_phase(dev):
    """Phase 9f: a plain BLS12-381 circuit (x <- x (x + 1), BLS381_CHAIN
    times, the result public: a 2^12 domain) set up, proved and verified
    on the card."""
    import torch

    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.groth16 import ConstraintSystem, Groth16

    cs = ConstraintSystem(F.BLS12_381_R)
    y = cs.pub_input(0)
    acc = cs.priv_input(3)
    for _ in range(BLS381_CHAIN):
        acc = cs.mul(acc, acc + 1)
    cs.values[1] = acc.value
    cs.assert_eq(acc, y)
    g16 = Groth16("bls12_381", device=dev)
    t0 = time.perf_counter()
    pk, vk = g16.setup(cs, rng=random.Random(SEED))
    torch.cuda.synchronize()
    out = {"constraints": len(cs.constraints), "domain_log": pk.domain_log,
           "setup_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    proof = g16.prove(pk, cs)
    out["prove_s"] = time.perf_counter() - t0
    public = cs.public_values()
    check(g16.verify(vk, proof, public), "the BLS12-381 proof does not verify")
    check(not g16.verify(vk, proof, [public[0] + 1]),
          "the BLS12-381 proof verifies against a wrong public input")
    say(f"[9f] BLS12-381 plain Groth16 on the card, true and false: {out}")
    return out


L64_CURVES = ("bw6_g1", "bw6_g2")  # BW6-761: both groups over the 761-bit Fp


def l64_phase(dev, rng_np, regs):
    """[11a] B1-B6 at L = 64 (BW6-761) against their plain versions: B1 on
    both groups' random sums, edge cases and points rescaled near p - 1
    (planes and rows); B6 on BW6-761's Fp; then a 4,096-point G1 MSM and
    a G2 MSM through `msm` (the scan path for both groups), each equal to
    its host oracle, with B1's first planes and B2-B5's calls recorded and
    held against their plain versions (B4 against its split order).
    Returns {kernel name: result} (G1's calls for B1-B5)."""
    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.msm import msm

    res = {}
    b1 = {name: b1_phase(dev, name, tag="[11a]") for name in L64_CURVES}
    res[K.B1_L64.name] = b1["bw6_g1"]["planes"][B1_SIZES[1]]
    res[K.B6_L64.name] = mont_mul_phase(
        dev, names=("bw6_761_fp",), tag="[11a]")["bw6_761_fp"]
    for name in L64_CURVES:
        case = tiled_msm_case(dev, rng_np, n=4096, spec=getattr(C, name))
        with Capture(Capture.WRAPPERS + ("point_add_planes",)) as cap:
            out = msm_phase(msm, case)
        check(sorted(cap.calls) == sorted(cap.names), "B1-B5 recorded")
        say(f"[11a] 4,096-point {name} MSM through msm equal to the host "
            f"oracle: {out}")
        add_name, add = captured_add_phase(cap.args)
        say(f"[11a] {name} {add_name} on the MSM's planes {add}")
        kernels = scan_kernels_phase(cap.calls, regs, f"[11a] {name}")
        if name == "bw6_g1":  # G1: 3b = -3, B2's negated small 3b
            res.update(kernels)
    return res


C2_ID = "voteverifier-c2"
C2_PROCESS_ID = 12345
C2_CONSTRAINTS = 3437706  # the reference's full-size build (BENCH_NOTES.md)


def c2_signing_key():
    """The voter's secp256k1 key of phase 10a's witness, from the seed."""
    from davinci_tpu_torch import curves as C

    return random.Random(SEED).randrange(1, C.secp256k1.r)


def c2_inputs(c1):
    """Phase 10a: the production vote verifier's parameters and witness
    (BN254 inner pairing with c1's verifying key, secp256k1 signed by
    `ethereum.sign`, the lookup tier), from c1's proof made on the card:
    the construction of the reference's scripts/fullsize_c2.py.  The
    inputs are written to build/c1_vector.json for the tests."""
    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch.circuits.voteverifier import (
        VoteVerifierParams,
        make_vote_verifier_witness,
    )
    from davinci_tpu_torch.ethereum import sign
    from davinci_tpu_torch.groth16.serialize import proof_to_dict, vk_to_bytes
    from davinci_tpu_torch.pairing import bn254_pairing

    params = VoteVerifierParams(inner_ctx=bn254_pairing, inner_vk=c1["vk"],
                                sig_spec=C.secp256k1, use_lookup=True)
    priv = c2_signing_key()

    def eth_sign(d, e):
        r, s, _ = sign(d, e.to_bytes(32, "big"))
        return r, s

    t0 = time.perf_counter()
    w = make_vote_verifier_witness(
        params, process_id=C2_PROCESS_ID, priv_sig_key=priv,
        inputs_hash=c1["inputs_hash"], ballot_proof=c1["proof"],
        vote_id=c1["vote_id"], sign_fn=eth_sign)
    took = time.perf_counter() - t0
    vector = {"process_id": C2_PROCESS_ID, "priv_sig_key": priv,
              "inputs_hash": c1["inputs_hash"], "vote_id": c1["vote_id"],
              "proof": proof_to_dict(c1["proof"]),
              "vk": vk_to_bytes(c1["vk"], C.bn254_g1, C.bn254_g2).hex()}
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "c1_vector.json").write_text(json.dumps(vector))
    say(f"[10a] c2 witness from c1's proof in {took:.3f} s: address "
        f"{w.address:#x}, vote hash {w.vote_hash(params.hash_p):#x}")
    return params, w


def reuse_prove(rt, cs, stages, tag, replay=False, what="c2",
                kernels=COMMITTED_KERNELS, tamper=0):
    """One steady `prove_committed_reuse` of `what` (c2, c4), verified and
    refused with public value `tamper` + 1; its stage times
    (`groth16.refinalize`: the challenge's wires re-solved on the host),
    the launches of `kernels` (each must be launched) and peak memory.
    With `replay`, the first and the largest call of each kernel wrapper
    are kept (their inputs stay on the card to the end of the prove, so
    the peak counts them) and made again against their plain versions
    (`replay_phase`).  Returns (the record, the proof)."""
    import contextlib

    import torch

    from davinci_tpu_torch import kernels as K

    for k in K.KERNELS:
        k.launches = 0
    stages.reset()
    cap = Capture(Capture.PROVE, largest=True)
    t0 = time.perf_counter()
    with cap if replay else contextlib.nullcontext():
        proof = rt.prove_committed_reuse(cs)
    torch.cuda.synchronize()
    rec = {"prove_s": time.perf_counter() - t0,
           "stages_s": {name: stages.took.get(name)
                        for name in COMMITTED_STAGES},
           "launches": {k.name: k.launches for k in K.KERNELS
                        if k.name in kernels},
           "peak_mem_gib": stages.peak_gib(),
           "inputs_held_for_replay": replay}
    if stages.mem is not None:
        rec["stage_memory"] = dict(stages.mem)
    rec["rest_s"] = rec["prove_s"] - sum(
        v or 0 for v in rec["stages_s"].values())
    for name, n in rec["launches"].items():
        check(n > 0, f"{name} was not launched by {what}'s steady prove")
    public = cs.public_values()
    t0 = time.perf_counter()
    check(rt.verify_committed(proof, public),
          f"{tag} {what} proof does not verify")
    rec["verify_s"] = time.perf_counter() - t0
    check(not rt.verify_committed(proof, bumped(public, tamper)),
          f"{tag} {what} proof verifies with public value {tamper} + 1")
    say(f"{tag} steady {what} prove: {json.dumps(rec)}")
    if replay:
        # B1's rows serve setup and the fused route, which a prove may not
        # reach
        missing = set(cap.names) - set(cap.calls) - {"point_add"}
        check(not missing, f"{what}'s prove called no {sorted(missing)}")
        t0 = time.perf_counter()
        rec["kernels"] = replay_phase(cap, tag)
        rec["replay_s"] = time.perf_counter() - t0
        del cap
    return rec, proof


def resident_uploads(bases, spans, device):
    """The segments as before streaming: slices of the whole set, uploaded
    once and kept on the key (`EncodedBases.device`)."""
    arrs = bases.device(device)
    for ofs, hi in spans:
        yield tuple(a[ofs:hi] for a in arrs)


def synchronous_uploads(bases, spans, device):
    """Each segment copied from the host arrays on the compute stream when
    its MSM starts: no helper thread, no side stream."""
    import torch

    for ofs, hi in spans:
        yield tuple(torch.from_numpy(a[ofs:hi]).to(device)
                    for a in (bases.x, bases.y, bases.z))


def streaming_phase(rt, cs, stages, order=("resident", "port", "synchronous",
                                           "synchronous", "port",
                                           "resident")):
    """[10g] c2's steady reuse prove once for each entry of `order`, each
    verified and refused, with the segments of every set above a segment
    got to the card one way (`groth16.core._segment_uploads` replaced for
    the prove): `resident` (`resident_uploads`, the whole sets uploaded
    before the timer, as a steady prove found them before streaming),
    `port` (the port's own) or `synchronous` (`synchronous_uploads`).
    Returns the records, and each way's mean prove and `groth16.msms`
    seconds over `resident`'s."""
    from davinci_tpu_torch.groth16 import core
    from davinci_tpu_torch.groth16.bases import EncodedBases

    g16 = rt.g16
    big = [b for b in vars(rt.pk).values() if isinstance(b, EncodedBases)
           and len(b) > (g16.MSM_SEGMENT_G2 if b.x.ndim == 3
                         else g16.MSM_SEGMENT)]
    ways = {"resident": resident_uploads, "port": core._segment_uploads,
            "synchronous": synchronous_uploads}
    runs = {way: [] for way in order}
    for way in order:
        for b in big:
            if way == "resident":
                b.device(g16.device)
            else:
                b.drop_device()
        core._segment_uploads = ways[way]
        try:
            rec, _ = reuse_prove(rt, cs, stages, f"[10g] {way}")
        finally:
            core._segment_uploads = ways["port"]
        runs[way].append(rec)
    for b in big:
        b.drop_device()

    def mean(way, key):
        vals = [r["prove_s"] if key is None else r["stages_s"][key]
                for r in runs[way]]
        return sum(vals) / len(vals)

    out = {"runs": runs, "over_resident": {
        way: {"prove": mean(way, None) / mean("resident", None),
              "msms": mean(way, "groth16.msms")
              / mean("resident", "groth16.msms"),
              "commit": mean(way, "groth16.commit")
              / mean("resident", "groth16.commit")}
        for way in runs}}
    prove_s = {way: [r["prove_s"] for r in rs] for way, rs in runs.items()}
    msms_s = {way: [r["stages_s"]["groth16.msms"] for r in rs]
              for way, rs in runs.items()}
    say(f"[10g] c2's steady prove by upload, each way's mean over "
        f"resident's: {json.dumps(out['over_resident'])}; prove s "
        f"{json.dumps(prove_s)}, msms s {json.dumps(msms_s)}")
    return out


def c2_phase(stages, c1, root, replay=True):
    """Phase 10: the production vote verifier (c2) from phase 5's c1 proof:
    the witness [10a], one host build [10b], setup on the card through the
    store under `root` [10c], one steady reuse prove [10d] (its kernel
    calls replayed where `replay`).  Returns (results, the runtime, the
    built system, the build function, 10d's proof, c2's parameters)."""
    import torch

    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.circuits.artifacts import ArtifactStore
    from davinci_tpu_torch.circuits.voteverifier import (
        build_vote_verifier_circuit,
    )

    params, w = c2_inputs(c1)

    def build(challenge, blind):
        return build_vote_verifier_circuit(params, w, challenge, blind)

    t0 = time.perf_counter()
    cs = build(0, 1)
    out = {"build_s": time.perf_counter() - t0,
           "constraints": len(cs.constraints), "variables": cs.num_variables,
           "committed": len(cs.committed)}
    say(f"[10b] c2 built: {out['constraints']} constraints, "
        f"{out['variables']} variables, {out['committed']} committed wires in"
        f" {out['build_s']:.3f} s (the reference's: {C2_CONSTRAINTS})")
    if out["constraints"] != C2_CONSTRAINTS:
        say(f"[10b] finding: {out['constraints'] - C2_CONSTRAINTS:+d} "
            f"constraints against the reference's build from its own c1 key"
            f" (c2's structure depends on the inner key's constants)")

    for k in K.KERNELS:
        k.launches = 0
    stages.took.clear()
    t0 = time.perf_counter()
    rt = ArtifactStore(root).load_or_setup(C2_ID, "bls12_377", cs)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    out["artifacts_setup_s"] = stages.took.get("artifacts.setup")
    check(out["artifacts_setup_s"] is not None, "c2's store ran its setup")
    out["pk_bin_bytes"] = (root / C2_ID / "pk.bin").stat().st_size
    out["vk_bin_bytes"] = (root / C2_ID / "vk.bin").stat().st_size
    out["domain_log"] = rt.pk.domain_log
    out["structure_hash"] = rt.structure_hash
    out["setup_launches"] = {k.name: k.launches for k in K.KERNELS
                             if k.launches}
    say(f"[10c] c2 set up on the card through the store: "
        f"{out['setup_s']:.3f} s (setup {out['artifacts_setup_s']} s), "
        f"domain 2^{out['domain_log']}, pk.bin {out['pk_bin_bytes']} B, "
        f"vk.bin {out['vk_bin_bytes']} B, structure {out['structure_hash']}")
    rec, proof = reuse_prove(rt, cs, stages, "[10d]", replay=replay)
    out["steady"] = [rec]
    return out, rt, cs, build, proof, params


# the default run's c3: one slot (the sequencer's default is 4,
# provers.py:59; one keeps c3's domain at 2^18 and the run inside its time)
C3_SLOTS = 1
C3_STAGES = ("groth16.witness_reduce_dev", "groth16.quotient_ntt",
             "groth16.msms")
# the kernels of a BW6-761 prove: both groups' MSMs on the scan path at
# L = 64 (B1-B5), every Fr product of the witness and the NTT (B6 at
# L = 32: BW6-761's Fr is BLS12-377's Fp); of its setup: the curves' rows
# (B1) and the Fp products (B6 at L = 64)
C3_PROVE_KERNELS = ("point_add_g1_l64", "bucket_scan_g1_l64",
                    "bucket_reduce_g1_l64", "suffix_reduce_g1_l64",
                    "horner_g1_l64", "mont_mul_l32")
C3_SETUP_KERNELS = ("point_add_g1_l64", "mont_mul_l64")
# the kernel wrappers a BW6-761 prove reaches (no Fp2 group)
C3_WRAPPERS = tuple(name for name in Capture.PROVE
                    if name not in ("point_add_fp2", "horner_g2_kernel"))


def c3_build(c2_vk, vote, dummy, n_votes, tag):
    """[11b] the aggregator (c3) over `n_votes` slots, production shape
    (BW6-761, `inner_committed`: the c2 proofs carry the commitment
    extension): `vote`, (proof, vote hash), in slot 0 and `dummy` in the
    others.  Returns (its parameters, the built system, results)."""
    from davinci_tpu_torch.circuits.aggregator import (
        AggregatorParams,
        AggregatorWitness,
        batch_hash,
        build_aggregator_circuit,
    )

    params = AggregatorParams(inner_vk=c2_vk, dummy_proof=dummy[0],
                              dummy_public=dummy[1], n_votes=n_votes,
                              inner_committed=True)
    w = AggregatorWitness(vote_hashes=[vote[1]], proofs=[vote[0]])
    t0 = time.perf_counter()
    cs = build_aggregator_circuit(params, w)
    out = {"slots": n_votes, "build_s": time.perf_counter() - t0,
           "constraints": len(cs.constraints), "variables": cs.num_variables,
           "batch_hash": hex(batch_hash(params, w))}
    check(cs.public_values() == [batch_hash(params, w)],
          "c3's public value is the batch hash")
    say(f"{tag} c3 built ({n_votes} slots, one real vote): "
        f"{out['constraints']} constraints, {out['variables']} variables in"
        f" {out['build_s']:.3f} s, batch hash {out['batch_hash']}")
    return params, cs, out


class KeyedGroth16:
    """A Groth16 backend whose `setup` hands back a key already made
    (`pk`, `vk`), everything else its backend's: the store's `g16`
    parameter with it persists that key through the store's own write."""

    def __init__(self, g16, pk, vk):
        self._g16, self._key = g16, (pk, vk)

    def setup(self, cs, rng=None):
        return self._key

    def __getattr__(self, name):
        return getattr(self._g16, name)


class HostPeak:
    """The largest resident set of this process, in GiB, over a `with`
    block: /proc/self/status's VmRSS sampled every 0.2 s."""

    @staticmethod
    def rss_gib():
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
        raise RuntimeError("no VmRSS in /proc/self/status")

    def __enter__(self):
        import threading

        self.start_gib = self.peak_gib = self.rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.2):
            self.peak_gib = max(self.peak_gib, self.rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, self.rss_gib())


def rss_trail(t_run, every=30.0):
    """Print the host's resident set every `every` seconds on a daemon
    thread, so that a run the machine ends for memory leaves its last
    reading in the log."""
    import threading

    def trail():
        while True:
            time.sleep(every)
            say(f"[rss] {time.perf_counter() - t_run:.0f} s: "
                f"{HostPeak.rss_gib():.2f} GiB resident")

    threading.Thread(target=trail, daemon=True).start()


def key_bytes(pk):
    """(host, card) bytes of a proving key's base sets: the numpy
    coordinates and the tensors uploaded and packed from them."""
    import torch

    from davinci_tpu_torch.groth16.bases import EncodedBases

    host = card = 0
    for b in vars(pk).values():
        if isinstance(b, EncodedBases):
            host += b.x.nbytes + b.y.nbytes + b.z.nbytes
            for v in (*b._dev.values(), *b._packed.values()):
                for t in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(t, torch.Tensor):
                        card += t.nbytes
    return host, card


def tensors_in(obj):
    """The tensors in `obj`, a tensor or nested tuples, lists and dicts."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for part in obj for t in tensors_in(part)]
    return []


def card_memory(tag, when, g16=None, pk=None, cs=None, top=12):
    """One line of the card's memory `when` (after a step of `--c3` or
    `--c4`): allocated and reserved GiB (each step's peak is the
    step's record's, `StageTimes.peak_gib`); the bytes each long-lived holder keeps there (the key's
    base sets uploaded or packed, `pk._torch_idx`, `cs._torch_csr`, the
    NTT's stage and power tables, setup's fixed-base tables); and the
    `top` largest live blocks of `torch.cuda.memory_snapshot()`, each
    named by the holder whose tensor lies in it ("other": a tensor of
    no holder above), on a line before.  Returns the record."""
    import torch

    from davinci_tpu_torch.groth16.bases import EncodedBases

    holders = {}
    if pk is not None:
        for name, b in vars(pk).items():
            if isinstance(b, EncodedBases):
                holders[f"pk.{name}"] = tensors_in(
                    [*b._dev.values(), *b._packed.values()])
        holders["pk._torch_idx"] = tensors_in(
            (getattr(pk, "_torch_idx", None) or (None, ()))[1])
    if cs is not None:
        csr = getattr(cs, "_torch_csr", None)
        holders["cs._torch_csr"] = tensors_in(csr.parts if csr else [])
    if g16 is not None:
        holders["ntt._tables"] = tensors_in(g16.ntt._tables)
        holders["ntt._powers"] = tensors_in(g16.ntt._powers)
        holders["g16._tables"] = tensors_in(g16._tables)
    spans, held = [], {}
    for name, ts in holders.items():
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in ts}
        held[name] = sum(storages.values()) / 2**30
        spans += [(ptr, ptr + size, name) for ptr, size in storages.items()]
    blocks = []
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                start = b.get("address", addr)
                name = next((h for lo, hi, h in spans
                             if start <= lo < start + b["size"]), "other")
                blocks.append((b["size"] / 2**30, name))
            addr += b["size"]
    blocks.sort(reverse=True)
    largest = [[round(g, 4), h] for g, h in blocks[:top]]
    say(f"{tag} largest live blocks {when} (GiB, holder; {len(blocks)} "
        f"blocks): {json.dumps(largest)}")
    rec = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "reserved_gib": torch.cuda.memory_reserved() / 2**30,
           "holders_gib": held}
    say(f"{tag} card memory {when}: {json.dumps(rec)}")
    return {**rec, "largest_gib": largest}


def store_setup(cid, cs, root, stages, tag, key=None, curve="bw6_761",
                what="c3", setup_kernels=C3_SETUP_KERNELS):
    """[11c] `what` (c3; c4, c5 on BN254) set up on the card through the
    store under `root` as circuit `cid`: sizes of pk.bin and vk.bin, the
    domain, the setup's launches (each of `setup_kernels` must be
    launched; c3: B1 and B6 at L = 64) and the host's resident set before
    and at its peak.  With `key`, (Groth16 backend, pk, vk) of a setup already
    made, the store writes that key (`KeyedGroth16`) and launches nothing.
    Returns (the runtime, results)."""
    import gc

    import torch

    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.circuits.artifacts import ArtifactStore

    for k in K.KERNELS:
        k.launches = 0
    gc.collect()
    stages.reset()
    t0 = time.perf_counter()
    with HostPeak() as host:
        say(f"{tag} host resident {host.start_gib:.2f} GiB before the store")
        rt = ArtifactStore(root).load_or_setup(
            cid, curve, cs, g16=key and KeyedGroth16(*key))
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0,
           "artifacts_setup_s": stages.took.get("artifacts.setup"),
           "pk_bin_bytes": (root / cid / "pk.bin").stat().st_size,
           "vk_bin_bytes": (root / cid / "vk.bin").stat().st_size,
           "domain_log": rt.pk.domain_log,
           "structure_hash": rt.structure_hash,
           "setup_launches": {k.name: k.launches for k in K.KERNELS
                              if k.launches},
           "host_rss_gib": host.start_gib, "host_peak_gib": host.peak_gib,
           "host_rss_after_gib": HostPeak.rss_gib(),
           "peak_mem_gib": stages.peak_gib()}
    check(out["artifacts_setup_s"] is not None,
          f"{what}'s store ran its setup")
    check(rt.g16.device.type == "cuda", f"{what}'s Groth16 is on the card")
    for name in setup_kernels if key is None else ():
        check(out["setup_launches"].get(name, 0) > 0,
              f"{name} was not launched by {what}'s setup")
    done = "set up on the card" if key is None else "key written"
    say(f"{tag} {what} {done}"
        f" through the store: {out['setup_s']:.3f} s (setup"
        f" {out['artifacts_setup_s']} s), domain 2^{out['domain_log']},"
        f" pk.bin {out['pk_bin_bytes']} B, vk.bin {out['vk_bin_bytes']} B,"
        f" launches {out['setup_launches']}, host resident"
        f" {out['host_rss_gib']:.2f} GiB before, {out['host_peak_gib']:.2f}"
        f" GiB at the peak, {out['host_rss_after_gib']:.2f} GiB after; card"
        f" peak {out['peak_mem_gib']:.2f} GiB")
    return rt, out


def second_store(cid, cs, root, stages, tag, prove, curve, what):
    """A second store on `root` that must load `what`'s key (circuit
    `cid`) with no setup, then `prove(runtime)` (a verified, refused
    prove; its record): the load's seconds, the host's peak and the card's
    peak during it, and the card's memory after the prove.  Returns the
    results."""
    import gc

    from davinci_tpu_torch.circuits.artifacts import ArtifactStore

    gc.collect()
    stages.reset()
    with HostPeak() as host:
        rt = ArtifactStore(root).load_or_setup(cid, curve, cs)
    check("artifacts.load" in stages.took
          and "artifacts.setup" not in stages.took,
          f"the second store loaded {what}'s key with no setup")
    out = {"load_s": stages.took["artifacts.load"],
           "load_host_rss_gib": host.start_gib,
           "load_host_peak_gib": host.peak_gib,
           "load_peak_mem_gib": stages.peak_gib()}
    out["prove"] = prove(rt)
    out["memory"] = card_memory(tag, "after the second store's prove",
                                rt.g16, rt.pk, cs)
    say(f"{tag} a second store loaded {what}'s key with no setup in "
        f"{out['load_s']} s, proved and verified")
    return out


def setup_in_memory(params, cs, stages, tag, curve="bw6_761", what="c3",
                    setup_kernels=C3_SETUP_KERNELS):
    """[11c] `what` (c3, c4) set up on the card with no store: the setup's
    time, launches (each of `setup_kernels` must be launched), the domain,
    the key's bytes on the host and on the card, peak device memory and
    the host's resident set before and at its peak.  Returns (the runtime, the
    backend, pk, vk, results)."""
    import gc

    import torch

    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.circuits.artifacts import CircuitRuntime
    from davinci_tpu_torch.groth16 import Groth16
    from davinci_tpu_torch.groth16.serialize import cs_structure_hash

    for k in K.KERNELS:
        k.launches = 0
    gc.collect()
    stages.reset()
    g16 = Groth16(curve)
    t0 = time.perf_counter()
    with HostPeak() as host:
        pk, vk = g16.setup(cs)
        torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0, "domain_log": pk.domain_log,
           "setup_launches": {k.name: k.launches for k in K.KERNELS
                              if k.launches},
           "setup_peak_mem_gib": stages.peak_gib(),
           "host_rss_gib": host.start_gib, "host_peak_gib": host.peak_gib}
    out["key_host_bytes"], out["key_card_bytes"] = key_bytes(pk)
    for name in setup_kernels:
        check(out["setup_launches"].get(name, 0) > 0,
              f"{name} was not launched by {what}'s setup")
    say(f"{tag} {what} set up on the card in memory: {json.dumps(out)}")
    rt = CircuitRuntime(params.circuit_id(), curve, pk, vk,
                        cs_structure_hash(cs), g16)
    return rt, g16, pk, vk, out


def prove_verify(rt, cs, stages, tag, replay=False, what="c3",
                 kernels=C3_PROVE_KERNELS, wrappers=C3_WRAPPERS, tamper=0):
    """[11d] `prove_and_verify` of `what` (c3, c5), and `verify` false with
    public value `tamper` + 1 (c3: the batch hash): the stage times
    (witness, quotient NTT, MSMs, the rest of the prove), the launches of
    `kernels` (c3: B1-B5 at L = 64 and B6 at L = 32; each must be
    launched) and peak device memory.  With `replay`, the first
    and the largest call of each kernel wrapper are kept and made again
    against their plain versions (`replay_phase`)."""
    import contextlib

    import torch

    from davinci_tpu_torch import kernels as K

    for k in K.KERNELS:
        k.launches = 0
    stages.reset()
    cap = Capture(wrappers, largest=True)
    t0 = time.perf_counter()
    with cap if replay else contextlib.nullcontext():
        proof = rt.prove_and_verify(cs)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    prove_s = stages.took.get("circuit.prove")
    rec = {"prove_and_verify_s": total, "prove_s": prove_s,
           "verify_s": total - prove_s if prove_s is not None else None,
           "stages_s": {name: stages.took.get(name) for name in C3_STAGES},
           "launches": {k.name: k.launches for k in K.KERNELS
                        if k.name in kernels},
           "peak_mem_gib": stages.peak_gib(),
           "inputs_held_for_replay": replay}
    if stages.mem is not None:
        rec["stage_memory"] = dict(stages.mem)
    rec["rest_s"] = (prove_s or total) - sum(
        v or 0 for v in rec["stages_s"].values())
    for name, n in rec["launches"].items():
        check(n > 0, f"{name} was not launched by {what}'s prove")
    check(not rt.verify(proof, bumped(cs.public_values(), tamper)),
          f"{tag} {what} proof verifies with public value {tamper} + 1")
    say(f"{tag} {what} prove_and_verify, false for public value {tamper} + "
        f"1: {json.dumps(rec)}")
    if replay:
        # B1's rows serve setup, which a prove may not reach
        missing = set(cap.names) - set(cap.calls) - {"point_add"}
        check(not missing, f"{what}'s prove called no {sorted(missing)}")
        t0 = time.perf_counter()
        rec["kernels"] = replay_phase(cap, tag)
        rec["replay_s"] = time.perf_counter() - t0
        del cap
    return rec


def c3_dummy(c2_rt, c2_params, c1, tag):
    """The canonical dummy vote (`sequencer/provers.py:162-190`): a c2
    proof, under c2's key, of the fixed dummy witness (process 0, signing
    key 1, vote id 2^63).  The production c2 verifies an inner proof,
    which the reference's dummy leaves out (`ballot_proof=None`, which
    its inner-proof tier cannot build), so the dummy carries phase 5's c1
    proof and inputs hash.  Returns (the proof, its vote hash)."""
    from davinci_tpu_torch.circuits.voteverifier import (
        build_vote_verifier_circuit,
        make_vote_verifier_witness,
        witness_vote_hash,
    )

    w = make_vote_verifier_witness(
        c2_params, process_id=0, priv_sig_key=1,
        inputs_hash=c1["inputs_hash"], ballot_proof=c1["proof"],
        vote_id=1 << 63)
    vote_hash = witness_vote_hash(c2_params, w)
    t0 = time.perf_counter()
    proof = c2_rt.prove_and_verify_committed(
        lambda ch, bl: build_vote_verifier_circuit(c2_params, w, ch, bl),
        [vote_hash])
    say(f"{tag} the dummy vote's c2 proof, verified, in "
        f"{time.perf_counter() - t0:.3f} s (one build): vote hash "
        f"{vote_hash:#x}")
    return proof, vote_hash


C4_SEED = 0xC460  # the election of the reference's scripts/fullsize_c4.py
C4_PROCESS_ID = 424260
C4_TIERS = {"n_levels": 64, "census_levels": 20, "include_blob": True,
            "blob_domain_bits": 12, "use_lookup": True}  # the production's
# c4's overrides for `ProtocolProvers`: the sequencer passes n_votes,
# include_census and census_levels itself (provers.py:263-268)
C4_OVERRIDES = {k: v for k, v in C4_TIERS.items() if k != "census_levels"}
# the reference's builds at these tiers (BENCH_NOTES.md:17, 106-108)
C4_CONSTRAINTS = {2: 1563441, 60: 14993781}
# the kernels of a BN254 prove, committed or not: c1's (B1-B7 and B5's G2
# build at L = 22); of a BN254 setup: the G1 rows (B1) and the Fr
# products (B6)
BN254_KERNELS = ("point_add_g1", "bucket_scan_g1", "bucket_reduce_g1",
                 "suffix_reduce_g1", "horner_g1", "mont_mul",
                 "point_add_g2", "horner_g2")
BN254_SETUP_KERNELS = ("point_add_g1", "mont_mul")
C5_ID = "results-v1"  # the finalizer's (sequencer/pipeline.py:478)
C5_MAX_MESSAGE = 1 << 16  # the decryption's search bound: results <= votes


def sequencer_c4_witness(n_votes, tag):
    """[12a] c4's parameters and witness at `n_votes` votes and the
    production tiers, made by the port's `Sequencer` itself
    (`sequencer/pipeline.py:298-420`) with provers that keep c4's witness
    instead of proving it: the election of the reference's
    scripts/fullsize_c4.py:58-110 (one seeded `random.Random`: the key,
    the ballots, a 20-level LeanIMT census whose compressed proofs the
    sequencer decompresses), `tick_ballot`, `tick_aggregate` and
    `tick_transition` (re-encryption, the 64-level `prepare_votes_batch`,
    z and y from `pack_batch_blob(..., with_kzg=True)` on the card).
    Returns (params, witness, the state after the batch, the election's
    private key, the seconds of each step)."""
    import torch

    from davinci_tpu_torch import spec as protocol
    from davinci_tpu_torch.ballotmode import BallotMode
    from davinci_tpu_torch.census import CensusDB
    from davinci_tpu_torch.circuits.statetransition import (
        StateTransitionParams,
    )
    from davinci_tpu_torch.elgamal import Ballot, generate_key
    from davinci_tpu_torch.sequencer import (
        DevStubProvers,
        InMemoryChain,
        Sequencer,
    )
    from davinci_tpu_torch.sequencer.pipeline import ProcessInfo
    from davinci_tpu_torch.storage import MemoryKV, Storage

    class WitnessProvers(DevStubProvers):
        c4_overrides = C4_OVERRIDES  # the blob's z and y with its KZG

        def prove_state_transition(self, batch_summary):
            self.summary = batch_summary
            return super().prove_state_transition(batch_summary)

    took = {}
    t0 = time.perf_counter()
    rng = random.Random(C4_SEED)
    pub, priv = generate_key(rng)
    bm = BallotMode().pack()
    voters = [rng.randrange(2**160) for _ in range(n_votes)]
    cdb = CensusDB()
    cdb.new("c")
    for address in voters:
        cdb.insert("c", address, 1)
    census_root = cdb.publish("c")
    info = ProcessInfo(
        process_id=C4_PROCESS_ID, census_origin=1, ballot_mode=bm,
        encryption_key=(pub.x, pub.y),
        state_root=protocol.state_root(C4_PROCESS_ID, 1, pub.x, pub.y, bm),
        census_root=census_root)
    chain = InMemoryChain()
    chain.create_process(info)
    provers = WitnessProvers()
    seq = Sequencer(Storage(MemoryKV()), chain, provers=provers,
                    batch_time_window=0.0, votes_per_batch=n_votes,
                    census_levels=C4_TIERS["census_levels"])
    seq.register_process(info, priv_key=priv)
    for i, address in enumerate(voters):
        choice = [0] * protocol.FIELDS_PER_BALLOT
        choice[i % protocol.FIELDS_PER_BALLOT] = 1
        seq.submit_ballot(
            C4_PROCESS_ID, address,
            Ballot.encrypt(choice, pub, rng.randrange(1, 2**200)),
            protocol.VOTE_ID_MIN + rng.randrange(2**40),
            client={"inputs_hash": hex(rng.randrange(1 << 250))},
            census_proof=cdb.proof_by_root(census_root, address))
    took["ballots_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq.tick_ballot(max_items=n_votes)
    seq.tick_aggregate()
    seq.tick_transition(rng=rng)
    torch.cuda.synchronize()
    took["ticks_s"] = time.perf_counter() - t0
    summary = provers.summary
    w = summary["witness"]
    check(len(w.batch.votes) == n_votes and w.census_proofs is not None,
          "the sequencer batched every ballot with its census proof")
    params = StateTransitionParams(
        n_votes=summary["n_votes"], include_census=True,
        census_levels=summary["census_levels"], **C4_OVERRIDES)
    check(blob_y_is_the_host_evaluation(w, params.blob_domain_bits),
          "the blob's y is the host's barycentric evaluation at its z")
    say(f"{tag} c4 witness, {n_votes} votes, made by the sequencer: z "
        f"{w.blob_z:#x}, y {w.blob_y:#x}, seconds {json.dumps(took)}")
    return params, w, seq.states[C4_PROCESS_ID], priv, took


def blob_y_is_the_host_evaluation(w, domain_bits):
    """Whether c4's witness holds the blob's evaluation at z: the batch's
    cells in `pack_batch_blob`'s order (`state/blobcodec.py:29-34`),
    evaluated on the host
    (`barycentric_eval_host`) over the blob's domain."""
    from davinci_tpu_torch.circuits.blob_gadget import barycentric_eval_host
    from davinci_tpu_torch.circuits.statetransition import _blob_domain

    batch = w.batch
    cells = list(batch.new_results.coords()) + [batch.voters_count]
    for v in batch.votes:
        cells += [v.vote_id, v.address, v.ballot_index, v.weight]
        cells += v.reencrypted_ballot.coords()
    dom = _blob_domain(domain_bits)
    return w.blob_y == barycentric_eval_host(
        dom, cells + [0] * (len(dom) - len(cells)), w.blob_z)


def c4_build(params, w, tag):
    """[12a] c4 built once on the host, as the sequencer builds it before
    its store (`sequencer/provers.py:261-270`): the constraint, variable
    and committed-wire counts against the reference's, the domain, the
    constraints of the largest scopes, the build's seconds and the host's
    resident set before and at its peak.  Returns (the system, results)."""
    import gc
    from collections import Counter

    from davinci_tpu_torch.circuits.statetransition import (
        build_state_transition_circuit,
    )

    gc.collect()
    t0 = time.perf_counter()
    with HostPeak() as host:
        cs = build_state_transition_circuit(params, w)
    n = len(cs.constraints)
    out = {"votes": params.n_votes, "build_s": time.perf_counter() - t0,
           "constraints": n, "variables": cs.num_variables,
           "committed": len(cs.committed), "public": cs.num_public,
           "host_rss_gib": host.start_gib, "host_peak_gib": host.peak_gib,
           "reference_constraints": C4_CONSTRAINTS.get(params.n_votes)}
    out["scopes"] = dict(Counter(
        label.split("/")[0].rstrip("0123456789").rstrip("-")
        for label in cs._labels.values()).most_common())
    out["unlabeled"] = n - len(cs._labels)
    publics = cs.public_values()
    check(publics[:3] == [w.batch.root_before, w.batch.root_after,
                          w.batch_hash(params)],
          "c4's publics are root_before, root_after and the batch hash")
    say(f"{tag} c4 built: {json.dumps(out)}")
    if out["reference_constraints"] is not None:
        check(n == out["reference_constraints"],
              f"c4 at {params.n_votes} votes has the reference's "
              f"{out['reference_constraints']} constraints")
    return cs, out


def resolve(cs):
    """A `build_fn` for `prove_committed` that hands back `cs`, already
    built, re-solved in place for (challenge, blind): its blind wire set,
    then the challenge's wires through its `_refinalize` hook (for the
    first phase's challenge 0, `prove_committed` re-solves them itself
    once it has D).  The sequencer builds c4 a second time there
    (`provers.py:278-285`); at full size the host holds one system."""
    def build(challenge, blind):
        cs.values[cs.committed[-1]] = blind
        if challenge:
            cs._refinalize(challenge)
        return cs
    return build


def c4_first_prove(rt, cs, stages, tag):
    """[12c] `prove_and_verify_committed` of c4 (`resolve` as its builder),
    and `verify_committed` false with root_after + 1: the seconds, the
    stage times, the launches of the L = 22 kernels (each must be
    launched), peak device memory and the host's resident set.  Returns
    (results, the proof)."""
    import torch

    from davinci_tpu_torch import kernels as K

    for k in K.KERNELS:
        k.launches = 0
    stages.reset()
    public = cs.public_values()
    t0 = time.perf_counter()
    with HostPeak() as host:
        proof = rt.prove_and_verify_committed(resolve(cs), public)
        torch.cuda.synchronize()
    rec = {"prove_and_verify_s": time.perf_counter() - t0,
           "stages_s": {name: stages.took.get(name)
                        for name in COMMITTED_STAGES
                        + ("circuit.prove_committed",)},
           "launches": {k.name: k.launches for k in K.KERNELS
                        if k.name in BN254_KERNELS},
           "peak_mem_gib": stages.peak_gib(),
           "host_rss_gib": host.start_gib, "host_peak_gib": host.peak_gib}
    if stages.mem is not None:
        rec["stage_memory"] = dict(stages.mem)
    for name, n in rec["launches"].items():
        check(n > 0, f"{name} was not launched by c4's committed prove")
    check(not rt.verify_committed(proof, bumped(public, 1)),
          f"{tag} c4 proof verifies with root_after + 1")
    say(f"{tag} c4 prove_and_verify_committed, false for root_after + 1: "
        f"{json.dumps(rec)}")
    return rec, proof


# phase 13: c4's slots, the sequencer's `votes_per_batch`, which c4's
# n_votes follows (pipeline.py:412) whatever the ballots in the batch
SEQ_VOTES = 2
# the kernels each step of phase 13 must launch: the proving worker's c2
# prove (its setup adds B6 at L = 32; the ballot tick then finds no
# pending ballot), c3's prove and setup, c4's and c5's BN254 proves (the
# transition's blob adds its KZG MSM on the L = 32 G1 kernels)
TICK_KERNELS = {
    "worker": COMMITTED_KERNELS,
    "tick_ballot": (),
    "tick_aggregate": C3_PROVE_KERNELS + C3_SETUP_KERNELS,
    "tick_transition": BN254_KERNELS + ("point_add_g1_l32",
                                        "bucket_scan_g1_l32", "mont_mul_l32"),
    "tick_onchain": (),
    "tick_finalizer": BN254_KERNELS,
}


class KeptBuilds:
    """While installed, the circuit builders the sequencer calls
    (`sequencer/provers.py`'s module names, and `circuits/results.py`'s,
    which the finalizer imports when it runs) keep what they build:
    `built[name]` lists (witness, system, seconds).  A second call for the
    same witness gets that system back, re-solved in place for its
    (challenge, blind) as `resolve` does, where the provers' committed
    proves build it again (`provers.py:120-130, 278-285`): the host holds
    one system, and the prove is the one a second build would give."""

    NAMES = ("build_vote_verifier_circuit", "build_aggregator_circuit",
             "build_state_transition_circuit", "build_results_circuit")

    def __init__(self):
        self.built = {}

    @staticmethod
    def _module(name):
        from davinci_tpu_torch.circuits import results
        from davinci_tpu_torch.sequencer import provers

        return results if name == "build_results_circuit" else provers

    def last(self, name):
        """(witness, system) of `name`'s last build."""
        return self.built[name][-1][:2]

    def __enter__(self):
        self.saved = {name: getattr(self._module(name), name)
                      for name in self.NAMES}
        for name, fn in self.saved.items():
            def kept(*args, _name=name, _fn=fn, **kw):
                w = args[0] if _name == "build_results_circuit" else args[1]
                made = self.built.setdefault(_name, [])
                for w0, cs, _ in made:
                    if w0 is w:
                        return resolve(cs)(**kw)
                t0 = time.perf_counter()
                cs = _fn(*args, **kw)
                made.append((w, cs, time.perf_counter() - t0))
                return cs
            setattr(self._module(name), name, kept)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self._module(name), name, fn)


class RuntimeProves:
    """While installed, every `prove_and_verify` and
    `prove_and_verify_committed` of a `CircuitRuntime` is recorded:
    `proves[circuit_id]` = (the runtime, the proof, seconds).  A circuit
    whose id starts with a key of `capture` proves inside
    `Capture(capture[key], largest=True)`, kept in `captures[circuit_id]`
    for `replay_phase`."""

    METHODS = ("prove_and_verify", "prove_and_verify_committed")

    def __init__(self, capture=None):
        self.capture = capture or {}
        self.proves, self.captures = {}, {}

    def __enter__(self):
        import contextlib

        import torch

        from davinci_tpu_torch.circuits.artifacts import CircuitRuntime

        self.saved = {name: getattr(CircuitRuntime, name)
                      for name in self.METHODS}
        for name, fn in self.saved.items():
            def recorded(rt, *args, _fn=fn, **kw):
                cap = next((Capture(names, largest=True)
                            for prefix, names in self.capture.items()
                            if rt.circuit_id.startswith(prefix)), None)
                t0 = time.perf_counter()
                with cap or contextlib.nullcontext():
                    proof = _fn(rt, *args, **kw)
                torch.cuda.synchronize()
                self.proves[rt.circuit_id] = (rt, proof,
                                              time.perf_counter() - t0)
                if cap is not None:
                    self.captures[rt.circuit_id] = cap
                return proof
            setattr(CircuitRuntime, name, recorded)
        return self

    def __exit__(self, *exc):
        from davinci_tpu_torch.circuits.artifacts import CircuitRuntime

        for name, fn in self.saved.items():
            setattr(CircuitRuntime, name, fn)


def tick(seq, name, stages, kept, **kw):
    """One tick of the sequencer, `name`, through `drive`."""
    return drive(name, lambda: getattr(seq, name)(**kw), stages, kept)


def drive(name, step, stages, kept):
    """One step of phase 13, `name` (a tick of the sequencer, or the
    proving worker's job), driven by calling `step` with every launch
    count set to 0 just before it and read just after: its seconds, the
    kernels it launched (each of `TICK_KERNELS[name]` must be), its stage
    times, peak device memory, and the constraints of each circuit it
    built."""
    import torch

    from davinci_tpu_torch import kernels as K

    builds = {n: len(made) for n, made in kept.built.items()}
    stages.took.clear()
    for k in K.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t0,
           "launches": {k.name: k.launches for k in K.KERNELS if k.launches},
           "stages_s": dict(stages.took),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "built": {n.removeprefix("build_").removesuffix("_circuit"): {
               "constraints": len(cs.constraints),
               "variables": cs.num_variables, "build_s": s}
               for n, made in kept.built.items()
               for _, cs, s in made[builds.get(n, 0):]}}
    say(f"[13] {name}: {json.dumps(rec)}")
    for kernel in TICK_KERNELS[name]:
        check(rec["launches"].get(kernel, 0) > 0,
              f"{kernel} was not launched by {name}")
    return rec


def election_inputs(c1, params, w):
    """Phase 13's process and ballot: c1's election (its key, ballot mode
    and encrypted ballot, phase 5), a census of eight voters with c2's
    signer among them (a LeanIMT, compressed proofs), the wire ballot
    with c2's client material: c1's proof, its inputs hash, and the
    secp256k1 signature and key of `c2_inputs`.  Returns (the process,
    the private key, the `submit_ballot` arguments, the census)."""
    from davinci_tpu_torch import spec as protocol
    from davinci_tpu_torch.census import CensusDB
    from davinci_tpu_torch.groth16.serialize import proof_to_dict
    from davinci_tpu_torch.sequencer.pipeline import ProcessInfo

    bw = c1["ballot"]
    kx, ky = bw.pubkey
    bm = bw.ballot_mode.pack()
    rng = random.Random(SEED + 13)
    voters = [rng.randrange(2**160) for _ in range(7)]
    voters.insert(3, w.address)
    cdb = CensusDB()
    cdb.new("c")
    for address in voters:
        cdb.insert("c", address, 1)
    census_root = cdb.publish("c")
    info = ProcessInfo(
        process_id=w.process_id, census_origin=1, ballot_mode=bm,
        encryption_key=(kx, ky),
        state_root=protocol.state_root(w.process_id, 1, kx, ky, bm),
        census_root=census_root)
    ballot = {
        "pid": w.process_id, "address": w.address, "ballot": bw.ballot,
        "vote_id": w.vote_id, "weight": 1,
        "client": {"ballot_proof": proof_to_dict(c1["proof"]),
                   "inputs_hash": hex(w.inputs_hash),
                   "sig_r": hex(w.sig_r), "sig_s": hex(w.sig_s),
                   "pubkey": [w.pubkey.x.v, w.pubkey.y.v]},
        "census_proof": cdb.proof_by_root(census_root, w.address)}
    check(bw.process_id == w.process_id, "c1 and c2 are of one process")
    return info, c1["priv"], ballot, cdb


# the proving farm's master seed (worker ids and tokens derive from it)
WORKER_SEED = "chip-smoke"


class IntKeyProvers:
    """A proving worker's provers: `provers.prove_vote` on the job's item
    with the voter's key as ints.  Queue C: `api.py` stores the key it
    recovers from the signature as hex strings, and `provers.py` hands
    them to `spec.point`, which turns only ints into field elements (an
    AttributeError at "solve" or "prove").  The error is kept here, since
    `WorkerClient` reports only its message to the master."""

    def __init__(self, provers):
        self.provers, self.error = provers, None

    def prove_vote(self, item):
        client = dict(item["client"])
        client["pubkey"] = [int(v, 16) for v in client["pubkey"]]
        try:
            return self.provers.prove_vote({**item, "client": client})
        except Exception as e:
            self.error = e
            raise


def http_json(base, method, path, body=None):
    """One request to the node's HTTP API at `base`: (status, JSON)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_intake(base, ballot, w):
    """Phase 13's way in: the voter's census proof fetched from the API,
    three votes refused (a signature by another key, 401; the ballot
    proof's inputs hash + 1, 401, after the pairing; an address outside
    the census, signed by its own key, 401, whose census proof the API
    does not have, 404), then the ballot of c2's witness posted as a
    client sends it: the wire ballot, the EIP-191 signature of its key
    over the vote ID, the census proof and c1's proof as `ballotProof`.
    Returns the statuses and answers."""
    from davinci_tpu_torch import ethereum as eth
    from davinci_tpu_torch.sequencer.pipeline import ballot_to_wire

    def signed(key):
        payload = ballot["vote_id"].to_bytes(8, "big").rjust(32, b"\x00")
        r, s_, rec = eth.sign_eth_prefixed(key, payload)
        return {"r": r, "s": s_, "rec": rec}

    root, address = ballot["census_proof"]["root"], ballot["address"]
    status, got = http_json(base, "GET", f"/censuses/{root}/proof/{address}")
    check(status == 200, f"census proof over HTTP: {status} {got}")
    sig = signed(c2_signing_key())
    check((sig["r"], sig["s"]) == (w.sig_r, w.sig_s),
          "the EIP-191 signature over the vote ID is c2's witness's")
    client = ballot["client"]
    good = {"processID": ballot["pid"], "address": address,
            "voteID": ballot["vote_id"], "weight": ballot["weight"],
            "ballot": [str(c) for c in ballot_to_wire(ballot["ballot"])],
            "signature": sig,
            "censusProof": {"kind": "merkle", "proof": got["proof"]},
            "ballotProof": {"proof": client["ballot_proof"],
                            "inputsHash": client["inputs_hash"]}}
    other = random.Random(SEED + 14).randrange(1, eth.N)
    outsider = int.from_bytes(
        eth.address_from_pubkey(eth.pubkey_from_priv(other)), "big")
    out = {}
    for what, body, want in (
            ("another key's signature", {**good, "signature": signed(other)},
             (401, "signature does not match address")),
            ("inputs hash + 1", {**good, "ballotProof": {
                **good["ballotProof"],
                "inputsHash": hex(int(client["inputs_hash"], 16) + 1)}},
             (401, "ballot proof invalid")),
            ("an address outside the census",
             {**good, "address": outsider, "signature": signed(other)},
             (401, "census proof invalid"))):
        t0 = time.perf_counter()
        status, got = http_json(base, "POST", "/votes", body)
        out[what] = {"status": status, "error": got.get("error"),
                     "s": time.perf_counter() - t0}
        check((status, got.get("error")) == want,
              f"POST /votes with {what}: {status} {got}, not {want}")
    status, got = http_json(base, "GET", f"/censuses/{root}/proof/{outsider}")
    out["the outsider's census proof"] = {"status": status}
    check(status == 404, f"the outsider's census proof: {status} {got}")
    t0 = time.perf_counter()
    status, got = http_json(base, "POST", "/votes", good)
    out["the ballot"] = {"status": status, "answer": got,
                         "s": time.perf_counter() - t0}
    check(status == 200 and got == {"status": "pending",
                                    "voteID": ballot["vote_id"]},
          f"POST /votes with the ballot: {status} {got}")
    return out


def sequencer_phase(stages, c1, root):
    """Phase 13: one election through the port's `Sequencer` with the
    production provers (`ProtocolProvers` at "prove" for c2, c3 and c4;
    c2's parameters of phase 10, c3 at `C3_SLOTS` slots, c4 at
    `SEQ_VOTES` slots and the production tiers), its artifacts through a
    store under `root` (`DAVINCI_ARTIFACTS_DIR` too, the finalizer's
    `default_store()`).  The node's HTTP API (`api.serve` on 127.0.0.1,
    with a jobs manager and c1's key as its ballot verifier) takes the
    ballot and refuses three bad votes (`http_intake`); a proving worker
    (`WorkerClient`, over HTTP) proves c2 with the sequencer's provers;
    then `tick_ballot` (which finds no pending ballot), `tick_aggregate`,
    `tick_transition`, `tick_onchain`, `end_process` and
    `tick_finalizer(prove_real=True)`, a line each (`drive`).  Between
    the ticks, on the runtimes and systems the pipeline made, what phases
    10-12 measure: c2's steady reuse prove with its kernel calls replayed
    [10d]; c3's prove's kernel calls (recorded during the tick) replayed
    and its proof refused with the batch hash + 1 [11d]; c4's proof
    refused with root_after + 1, then one steady reuse prove, refused
    and replayed [12c]; c5's proof refused with results[0] + 1 [12d].
    Returns its results, with the launches of the worker and the ticks
    summed."""
    import os

    from davinci_tpu_torch.api import API, serve
    from davinci_tpu_torch.circuits import artifacts
    from davinci_tpu_torch.groth16 import Groth16
    from davinci_tpu_torch.sequencer import InMemoryChain, Sequencer
    from davinci_tpu_torch.sequencer.provers import (
        ProtocolProvers,
        ProverModes,
    )
    from davinci_tpu_torch.storage import MemoryKV, Storage
    from davinci_tpu_torch.workers import JobsManager, WorkerManager

    os.environ["DAVINCI_ARTIFACTS_DIR"] = str(root)
    params, w = c2_inputs(c1)
    info, priv, ballot, cdb = election_inputs(c1, params, w)
    provers = ProtocolProvers(
        params, store=artifacts.ArtifactStore(root),
        modes=ProverModes(vote="prove", aggregate="prove",
                          state_transition="prove"),
        n_votes_agg=C3_SLOTS, c4_overrides=C4_OVERRIDES)
    chain = InMemoryChain()
    chain.create_process(info)
    seq = Sequencer(Storage(MemoryKV()), chain, provers=provers,
                    batch_time_window=0.0, max_dl_bound=C5_MAX_MESSAGE,
                    votes_per_batch=SEQ_VOTES,
                    census_levels=C4_TIERS["census_levels"])
    seq.register_process(info, priv_key=priv)
    pid = info.process_id
    api = API(seq, cdb, jobs_manager=JobsManager(
        seq.storage, WorkerManager(WORKER_SEED)),
        ballot_verifier=(Groth16("bn254"), c1["vk"]))
    server, _ = serve(api, "127.0.0.1", 0)
    try:
        return node_phase(stages, seq, provers, params, w, ballot, server,
                          c1["ballot"].field_values, root)
    finally:
        server.shutdown()
        server.server_close()


def node_phase(stages, seq, provers, params, w, ballot, server, tally, root):
    """Phase 13 from the node's HTTP API on: the intake (`http_intake`),
    then a proving worker over HTTP with the sequencer's provers
    (`IntKeyProvers`), the ticks, and the vote's status over HTTP after
    the worker and once settled; `sequencer_phase` says the rest."""
    from davinci_tpu_torch.circuits import artifacts
    from davinci_tpu_torch.circuits.statetransition import (
        StateTransitionParams,
    )
    from davinci_tpu_torch.circuits.voteverifier import witness_vote_hash
    from davinci_tpu_torch.groth16.serialize import proof_from_dict
    from davinci_tpu_torch.storage import VoteIDStatus
    from davinci_tpu_torch.workers import WorkerClient, worker_uuid

    chain, pid = seq.chain, ballot["pid"]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    status_path = f"/votes/{ballot['vote_id']}/process/{pid}/status"
    out = {"votes_per_batch": SEQ_VOTES, "c3_slots": C3_SLOTS, "ticks": {}}
    out["intake"] = http_intake(base, ballot, w)
    [(s, item)] = seq.storage.pending_ballots.next(1)
    seq.storage.pending_ballots.release(s)
    # the API's item is the direct route's (`submit_ballot(**ballot)`) but
    # for the key, which it holds as hex strings (queue C)
    check(item["client"].pop("pubkey") == [hex(v) for v in
                                           ballot["client"]["pubkey"]]
          and item["client"] == {k: v for k, v in ballot["client"].items()
                                 if k != "pubkey"}
          and item["census_proof"] == ballot["census_proof"],
          "the API's pending ballot is the direct route's")
    out["status_pending"] = http_json(base, "GET", status_path)
    check(out["status_pending"] == (200, {"status": "pending"}),
          f"the vote's status after the intake: {out['status_pending']}")
    say(f"[13] HTTP intake on {base}: {json.dumps(out['intake'])}")

    def transport(method, path, body):  # `cli.cmd_worker`'s, checked
        status, got = http_json(base, method, path, body)
        check(status == 200, f"{method} {path}: {status} {got}")
        return got

    worker_provers = IntKeyProvers(provers)
    wid = worker_uuid(WORKER_SEED, "card-0")
    worker = WorkerClient(wid, transport, worker_provers)
    ticks = out["ticks"]
    with KeptBuilds() as kept, RuntimeProves({"aggregator": C3_WRAPPERS}) \
            as proves:
        took = []
        ticks["worker"] = drive("worker", lambda: took.append(worker.tick()),
                                stages, kept)
        check(worker_provers.error is None,
              f"the worker's prove failed: {worker_provers.error!r}")
        out["workers"] = http_json(base, "GET", "/sequencer/workers")
        check(took == [True] and out["workers"] == (200, {"workers": {
            wid: {"success": 1, "failures": 0, "banned": False}}}),
            f"the worker's job: {took} {out['workers']}")
        out["status_verified"] = http_json(base, "GET", status_path)
        check(out["status_verified"] == (200, {"status": "verified"}),
              f"the vote's status after the worker: {out['status_verified']}")
        check(seq.storage.pending_ballots.size() == 0,
              "a ballot is pending after the worker's job")
        say(f"[13] worker {wid} over HTTP: {json.dumps(out['workers'][1])}; "
            f"the vote's status {out['status_verified'][1]['status']}")
        ticks["tick_ballot"] = tick(seq, "tick_ballot", stages, kept)
        check(not ticks["tick_ballot"]["launches"]
              and seq.storage.verified_ballots.size() == 1,
              "tick_ballot found a pending ballot")
        [(s, item)] = seq.storage.verified_ballots.next(1)
        seq.storage.verified_ballots.release(s)
        vp = item["vote_proof"]
        check(vp["proven"] and int(vp["vote_hash"], 16)
              == witness_vote_hash(params, w),
              "c2's proof is proven, of the ballot's vote hash")
        check(provers.verify_vote(vp), "verify_vote refuses c2's proof")
        check(not provers.verify_vote(
            {**vp, "vote_hash": hex(int(vp["vote_hash"], 16) + 1)}),
            "verify_vote accepts c2's proof for the vote hash + 1")
        c2_rt = provers._c2_rt
        _, c2_cs = kept.last("build_vote_verifier_circuit")
        out["c2_steady"], _ = reuse_prove(c2_rt, c2_cs, stages, "[10d]",
                                          replay=True)
        del c2_cs
        kept.built.pop("build_vote_verifier_circuit")
        # the reference's canonical dummy vote (`provers.py:162-187`)
        # passes no ballot proof, which the production c2 cannot build:
        # it is given the proof and vote hash of this ballot's c2 proof
        provers._dummy = (proof_from_dict(vp["proof"], c2_rt.g16.g1,
                                          c2_rt.g16.g2),
                          int(vp["vote_hash"], 16))

        ticks["tick_aggregate"] = tick(seq, "tick_aggregate", stages, kept)
        [(s, agg)] = seq.storage.agg_batches.next(1)
        seq.storage.agg_batches.release(s)
        ap = agg["proof"]
        [c3_id] = [cid for cid in proves.proves if cid.startswith("aggregator")]
        c3_rt, c3_proof, _ = proves.proves[c3_id]
        bh = int(ap["batch_hash"], 16)
        check(ap["proven"] and ap["vote_hashes"] == [vp["vote_hash"]],
              "c3's proof is proven, of the ballot's vote hash")
        check(not c3_rt.verify(c3_proof, [bh + 1]),
              "c3's proof verifies with the batch hash + 1")
        out["c3_replay"] = replay_phase(proves.captures.pop(c3_id), "[11d]")
        kept.built.pop("build_aggregator_circuit")

        ticks["tick_transition"] = tick(seq, "tick_transition", stages, kept)
        [(s, tr)] = seq.storage.transition_batches.next(1)
        seq.storage.transition_batches.release(s)
        w4, c4_cs = kept.last("build_state_transition_circuit")
        [c4_id] = [cid for cid in proves.proves
                   if cid.startswith("statetransition")]
        c4_rt, c4_proof, _ = proves.proves[c4_id]
        public = c4_cs.public_values()
        params4 = StateTransitionParams(
            n_votes=SEQ_VOTES, include_census=True,
            census_levels=C4_TIERS["census_levels"], **C4_OVERRIDES)
        check(tr["proof"]["proven"]
              and tr["proof"]["public"] == [hex(x) for x in public]
              and public[:3] == [tr["root_before"], tr["root_after"],
                                 w4.batch_hash(params4)],
              "c4's proof is proven, of the batch's roots and batch hash")
        check(len(w4.batch.votes) == 1 and w4.census_proofs is not None,
              f"c4 holds one ballot in {SEQ_VOTES} slots, with its census")
        # c4's structure follows the ballots in the batch as well as its
        # slots (`statetransition.py:230-300`): one ballot in two slots
        # builds fewer constraints than the reference's full batch
        out["c4_constraints"] = {"built": len(c4_cs.constraints),
                                 "full_batch": C4_CONSTRAINTS.get(SEQ_VOTES)}
        # c3 hashes its n_votes_agg slots, c4 its votes_per_batch: the two
        # agree only where those are equal (provers.py:59, pipeline.py:412)
        out["batch_hash"] = {"c3": hex(bh), "c4": hex(public[2])}
        check(blob_y_is_the_host_evaluation(w4,
                                            C4_TIERS["blob_domain_bits"]),
              "the blob's y is the host's barycentric evaluation at its z")
        check(not c4_rt.verify_committed(c4_proof, bumped(public, 1)),
              "c4's proof verifies with root_after + 1")
        out["c4_steady"], _ = reuse_prove(
            c4_rt, c4_cs, stages, "[12c]", replay=True, what="c4",
            kernels=BN254_KERNELS, tamper=1)
        del c4_cs, public
        kept.built.pop("build_state_transition_circuit")

        ticks["tick_onchain"] = tick(seq, "tick_onchain", stages, kept)
        st = seq.states[pid]
        check(chain.process(pid).state_root == st.root == tr["root_after"],
              "the chain's root is the state's after the batch")
        check(seq.storage.vote_status(pid, w.vote_id) == VoteIDStatus.SETTLED,
              "the vote is settled")
        out["status_settled"] = http_json(base, "GET", status_path)
        check(out["status_settled"] == (200, {"status": "settled"}),
              f"the vote's status once settled: {out['status_settled']}")
        chain.end_process(pid)
        ticks["tick_finalizer"] = tick(seq, "tick_finalizer", stages, kept,
                                       rng=random.Random(SEED),
                                       prove_real=True)
    results = chain.process(pid).results
    tally = list(tally)
    check(results == tally, f"the results {results} are the tally {tally}")
    check(artifacts.default_store().root == root,
          "the finalizer's store is the run's")
    [(s, fin)] = seq.storage.verified_results.next(1)
    _, c5_cs = kept.last("build_results_circuit")
    c5_rt, c5_proof, _ = proves.proves[C5_ID]
    public = c5_cs.public_values()
    check(fin["proof"]["proven"] and public == [st.root] + results
          and fin["proof"]["public"] == [hex(x) for x in public],
          "c5's proof is proven, of the state root and the results")
    check(not c5_rt.verify(c5_proof, bumped(public, 1)),
          "c5's proof verifies with results[0] + 1")
    out["results"] = results
    out["proves_s"] = {cid: s for cid, (_, _, s) in proves.proves.items()}
    launches = {}
    for rec in ticks.values():
        for name, n in rec["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    out["info"] = http_json(base, "GET", "/info")
    check(out["info"][0] == 200 and out["info"][1]["processes"] == 1,
          f"/info: {out['info']}")
    say(f"[13] {len(ballot['census_proof']['siblings'])}-level census, one "
        f"ballot in {SEQ_VOTES} slots: settled, results {results}; proves "
        f"{json.dumps(out['proves_s'])}; launches of the ticks "
        f"{json.dumps(launches)}")
    return out


# phase 14: the cells' stage events (`blobs/cells.py`), and the blob key
# of `send-blob` (any funded key of the fake node)
CELL_STAGES = ("cells.intt", "cells.quotient", "cells.ntt", "cells.msm_many",
               "cells.decode")
CELL_IDS = (0, 64, 127)
BLOB_KEY = 0xB10B5EED


def run_cli(name, argv, stages):
    """One command of the port's CLI (`cli.main` with `sys.argv` set, as
    `python -m davinci_tpu_torch.cli ...` runs it), driven with every
    launch count set to 0 just before it and read just after: the JSON of
    its last line of output, its seconds, the kernels it launched, its
    stage times and peak device memory, on a line of its own."""
    import contextlib
    import io

    import torch

    from davinci_tpu_torch import cli
    from davinci_tpu_torch import kernels as K

    stages.took.clear()
    for k in K.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    printed, argv_was = io.StringIO(), sys.argv
    sys.argv = ["davinci-tpu", *argv]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            cli.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = argv_was
    rec = {"argv": argv, "s": time.perf_counter() - t0,
           "launches": {k.name: k.launches for k in K.KERNELS if k.launches},
           "stages_s": dict(stages.took),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "out": json.loads(printed.getvalue().strip().splitlines()[-1])}
    say(f"[14] {name}: {json.dumps(rec)}")
    return rec


def send_blob_phase(stages):
    """`send-blob --cells -n 1 --wait` against the port's `FakeEthNode` on
    127.0.0.1: the CLI signs and submits a version-1 sidecar of 128 cell
    proofs, which the node decodes and validates (sidecar version, proof
    count, versioned hashes; it then executes nothing at an account, so
    the receipt's status is 0x0).  Beside it, `compute_cell_proofs_device`
    on the same blob with its stage times and every kernel call recorded:
    its 128 proofs are the sidecar's; cells 0, 64 and 127 are the host
    path's `compute_cell_proof` and pass `verify_cell_proof`, and cell 0's
    proof is refused for cell 127; the recorded calls are replayed against
    their plain versions (`replay_phase`), with the bounds of B1's to
    B4's largest call.  Returns its record."""
    import torch

    from davinci_tpu_torch import ethereum as eth
    from davinci_tpu_torch.blobs import cells
    from davinci_tpu_torch.blobs.kzg import Blob, blob_to_commitment
    from davinci_tpu_torch.web3.blobtx import SIDECAR_VERSION_1
    from davinci_tpu_torch.web3.encoding import rlp_decode
    from davinci_tpu_torch.web3.fakenode import FakeEthNode

    node = FakeEthNode()
    decoded, real_decode = [], node._decode_raw_tx

    def decode(raw):  # the node's own checks; a Revert propagates
        got = real_decode(raw)
        decoded.append((raw, got))
        return got

    node._decode_raw_tx = decode
    server = node.serve()
    try:
        rec = run_cli("send-blob --cells", [
            "send-blob", "--rpc", f"http://127.0.0.1:{server.server_address[1]}/",
            "--privkey", hex(BLOB_KEY), "--cells", "-n", "1", "--wait",
            "--seed", str(SEED)], stages)
    finally:
        server.shutdown()
        server.server_close()
    sender = eth.address_from_pubkey(eth.pubkey_from_priv(BLOB_KEY))
    [(raw, (got_sender, _, _, nonce, hashes))] = decoded
    check(raw[0] == 0x03 and raw[1] == SIDECAR_VERSION_1,
          "a type-3 transaction with a version-1 sidecar")
    _, blobs, commitments, proofs = rlp_decode(raw[2:])
    check(got_sender == sender and nonce == 0 and len(hashes) == 1
          and len(proofs) == cells.CELLS_PER_BLOB
          and rec["out"]["from"] == "0x" + sender.hex()
          and rec["out"]["status"] in ("0x0", "0x1"),
          "the node took the sidecar of 128 proofs from the sender")
    for name in ("point_add_g1_l32", "bucket_scan_g1_l32", "mont_mul_l32"):
        check(rec["launches"].get(name, 0) > 0,
              f"{name} was not launched by send-blob --cells")
    out = {"send_blob": rec}

    rng = random.Random(SEED)  # the CLI's blob of --seed SEED
    blob = Blob([rng.randrange(1 << 248) for _ in range(cells.BLOB_CELLS)])
    check(blob.to_bytes() == blobs[0], "the CLI's blob is the seed's")
    stages.took.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Capture(Capture.PROVE, largest=True) as cap:
        dev_proofs = cells.compute_cell_proofs_device(blob)
    out["device_s"] = time.perf_counter() - t0
    out["stages_s"] = {k: stages.took[k] for k in CELL_STAGES}
    check(dev_proofs == [bytes(p) for p in proofs],
          "the device's 128 proofs are the sidecar's")
    commitment = bytes(commitments[0])
    check(commitment == blob_to_commitment(blob), "the sidecar's commitment")
    t0 = time.perf_counter()
    coeffs = cells.blob_to_coeffs(blob)
    host = {cid: cells.compute_cell_proof(blob, cid, coeffs)
            for cid in CELL_IDS}
    out["host_s"] = time.perf_counter() - t0
    check(all(host[cid] == dev_proofs[cid] for cid in CELL_IDS),
          f"cells {CELL_IDS}: the device's proofs are not the host path's")
    t0 = time.perf_counter()
    ext = cells.compute_cells(blob)
    for cid in CELL_IDS:
        check(cells.verify_cell_proof(commitment, cid, ext[cid],
                                      dev_proofs[cid]),
              f"cell {cid}'s proof does not verify")
    check(not cells.verify_cell_proof(commitment, 127, ext[127], dev_proofs[0]),
          "cell 0's proof verifies for cell 127")
    out["verify_s"] = time.perf_counter() - t0
    say(f"[14] cell proofs beside the CLI: {out['device_s']:.3f} s on the "
        f"card, stages {json.dumps(out['stages_s'])}; cells {CELL_IDS} equal "
        f"to the host path ({out['host_s']:.1f} s) and verified, one "
        f"refused ({out['verify_s']:.1f} s)")
    for name, work, kind in (("point_add_planes", b1_planes_work, "add"),
                             ("_bucket_scan", b2_work, "mixed"),
                             ("bucket_reduce_kernel", b3_work, "add"),
                             ("suffix_reduce_kernel", b4_work, "add")):
        args = max(cap.calls[name], key=call_size)
        nbytes, ops = work(args)
        out[f"{name}_bound"] = dict(zip(("bound_ms", "bound_by"), bound(
            nbytes, ops, kind, args[0].df.L)), bytes=nbytes, ops=ops)
    out["replay"] = replay_phase(cap, "[14]")
    say(f"[14] bounds of the largest B1-B4 calls: "
        f"{json.dumps({k: v for k, v in out.items() if k.endswith('_bound')})}")
    return out


def cli_phase(stages, root, seq_out):
    """Phase 14: the node's CLI on the card, through `cli.main`, before
    phase 13's store under `root` is removed: `send-blob --cells`
    (`send_blob_phase`); `e2e --votes 4 --prove-results` over the store
    (`DAVINCI_ARTIFACTS_DIR`), a fresh store object as a new process
    makes, which must load c5's key and not set it up again (the
    finalizer's discrete-log search bounded by `C5_MAX_MESSAGE`, as in
    phase 13: the results are at most the votes); `circuit-compile
    --export-only` over the store, which must write one `.sol` per BN254
    artifact, named by its structure hash.  A line per command (`run_cli`).
    Returns the records and the launches of the commands summed."""
    from davinci_tpu_torch import sequencer
    from davinci_tpu_torch.circuits import artifacts

    out = send_blob_phase(stages)

    card = sequencer.Sequencer

    class Bounded(card):
        def __init__(self, *a, **kw):
            kw.setdefault("max_dl_bound", C5_MAX_MESSAGE)
            super().__init__(*a, **kw)

    artifacts._default_store = None
    sequencer.Sequencer = Bounded
    try:
        e2e = out["e2e"] = run_cli("e2e --prove-results", [
            "e2e", "--votes", "4", "--prove-results"], stages)
    finally:
        sequencer.Sequencer = card
    res = e2e["out"]
    check(res["results_proven"] and res["votes"] == 4
          and res["results"][0] + res["results"][1] == 4,
          f"e2e's results: {res}")
    check("artifacts.load" in e2e["stages_s"]
          and "artifacts.setup" not in e2e["stages_s"],
          "e2e set c5's key up again")
    for name in BN254_KERNELS:
        check(e2e["launches"].get(name, 0) > 0,
              f"{name} was not launched by e2e --prove-results")
    setup_s = seq_out["ticks"]["tick_finalizer"]["stages_s"]["artifacts.setup"]
    say(f"[14] c5's key: set up in {setup_s} s by phase 13's finalizer, "
        f"loaded in {e2e['stages_s']['artifacts.load']} s by e2e")

    sol_dir = root / "sol"
    cc = out["circuit_compile"] = run_cli("circuit-compile --export-only", [
        "circuit-compile", "--artifacts-dir", str(root), "--out",
        str(sol_dir), "--export-only"], stages)
    metas = [json.loads(m.read_text()) for m in sorted(root.glob("*/meta.json"))]
    want = [f"{m['circuit_id']}.{m['structure_hash'][:16]}.sol"
            for m in metas if m["curve"] == "bn254"]
    check(len(want) == 2 and cc["out"] == {"compiled": [], "exported": want}
          and all("pragma solidity" in (sol_dir / name).read_text()
                  for name in want),
          f"circuit-compile wrote {cc['out']}, not one .sol per BN254 key "
          f"{want}")
    launches = {}
    for rec in (out["send_blob"], e2e, cc):
        for name, n in rec["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    return out


def c4_only(n_votes):
    """`--c4 [N]`: c4 at N votes (default 60, the production batch, whose
    count must be the reference's 14,993,781) and the production tiers,
    the flow of `--c3`: the witness and the build [12a], setup on the card
    in memory [12b], `prove_and_verify_committed` [12c] and one steady
    reuse prove [12e], each verified and refused with root_after + 1, then
    the key written through the store, a section at a time, and a second
    store on the same directory that must load it with no setup, prove
    and verify [12f] (no kernel replay); the host's resident set sampled
    around each step and printed every 30 s (`rss_trail`).  The card's
    memory after setup, after each prove (`card_memory`: the holders and
    the largest live blocks) and by stage inside each prove
    (`StageTimes(memory=True)`), and the peak of each step on a line of
    its own."""
    import gc
    import tempfile

    import torch

    from davinci_tpu_torch import log

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    device_line()
    rss_trail(t_run)
    build_phase([(src, limbs) for src in ("point_add", "bucket", "mont_mul")
                 for limbs in (22, 32)])
    stages = StageTimes(memory=True)
    log.init()
    logging.getLogger("davinci").addHandler(stages)
    params, w, _, _, out = sequencer_c4_witness(n_votes, "[12a]")
    cs, out["build"] = c4_build(params, w, "[12a]")
    del w
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="store-", dir=ROOT / "build"))
    try:
        rt, g16, pk, vk, out["in_memory"] = setup_in_memory(
            params, cs, stages, "[12b]", curve="bn254", what="c4",
            setup_kernels=BN254_SETUP_KERNELS)
        mem = out["card_memory"] = {
            "setup": card_memory("[12b]", "after setup", g16, pk, cs)}
        out["first_prove"], _ = c4_first_prove(rt, cs, stages, "[12c]")
        mem["first_prove"] = card_memory("[12c]", "after the first prove",
                                         g16, pk, cs)
        with HostPeak() as host:
            out["steady"], _ = reuse_prove(rt, cs, stages, "[12e]",
                                           what="c4", kernels=BN254_KERNELS,
                                           tamper=1)
        out["steady"]["host_peak_gib"] = host.peak_gib
        mem["steady"] = card_memory("[12e]", "after the steady prove",
                                    g16, pk, cs)
        del rt
        gc.collect()
        rt, out["store"] = store_setup(
            params.circuit_id(), cs, root, stages, "[12b]",
            key=(g16, pk, vk), curve="bn254", what="c4")
        # the written key leaves the host before the second store reads it
        del rt, g16, pk, vk
        out["second_store"] = second_store(
            params.circuit_id(), cs, root, stages, "[12f]",
            lambda rt2: reuse_prove(rt2, cs, stages, "[12f]", what="c4",
                                    kernels=BN254_KERNELS, tamper=1)[0],
            curve="bn254", what="c4")
    finally:
        shutil.rmtree(root)
    out["card_peak_gib"] = {
        "setup": out["in_memory"]["setup_peak_mem_gib"],
        "first_prove": out["first_prove"]["peak_mem_gib"],
        "steady": out["steady"]["peak_mem_gib"],
        "store_write": out["store"]["peak_mem_gib"],
        "store_load": out["second_store"]["load_peak_mem_gib"],
        "second_store_prove": out["second_store"]["prove"]["peak_mem_gib"]}
    say(f"[12f] c4 at {n_votes} votes, the card's peak of each step, GiB: "
        f"{json.dumps(out['card_peak_gib'])}")
    out["run_s"] = time.perf_counter() - t_run
    say(json.dumps({"c4": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


POSEIDON_ROWS = ((3, 1 << 16), (17, 4096), (2, 1024), (5, 1024))


def poseidon_phase(dev):
    """[15a] DevicePoseidon on the card at each (t, rows) of POSEIDON_ROWS:
    rows 0, the last and 254 sampled ones against the host hash."""
    import torch

    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.hash import get_device_poseidon, poseidon_hash

    rng = random.Random(SEED + 15)
    out = {}
    for t, n in POSEIDON_ROWS:
        dp = get_device_poseidon(t, device=dev)
        spec = dp.spec
        rows = [[rng.randrange(spec.p) for _ in range(t - 1)] for _ in range(n)]
        arr = torch.as_tensor(spec.batch_to_limbs(
            [v * spec.r % spec.p for row in rows for v in row]),
            device=dev).reshape(n, t - 1, dp.df.L)
        dp.hash(arr[:2])  # the constants' first use
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.B6.launches = 0
        t0 = time.perf_counter()
        got = dp.hash(arr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = K.B6.launches
        check(launches > 0, f"Poseidon t={t} did not launch B6")
        hashes = dp.df.decode(got)
        sample = [0, n - 1] + rng.sample(range(1, n - 1), 254)
        check(all(hashes[i] == poseidon_hash(rows[i]) for i in sample),
              f"Poseidon t={t} differs from the host hash")
        out[f"t{t}"] = {"rows": n, "s": secs, "hashes_per_s": n / secs,
                        "b6_launches": launches, "checked_rows": len(sample),
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        say(f"[15a] Poseidon t={t}: {n} rows in {secs:.4f} s "
            f"({n / secs:.0f} hashes/s), B6 launches {launches}, "
            f"{len(sample)} sampled rows equal to poseidon_hash")
    return out


def mesh_phase(dev, c1, inner, case4, kernels):
    """[15b] The multi-card path on a world-size-1 NCCL group: sharded
    NTT, sharded MSMs (G1 and G2), c1 proved with set_mesh."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.msm import msm, sharded_msm
    from davinci_tpu_torch.ntt import get_device_ntt
    from davinci_tpu_torch.parallel import distributed_init, get_mesh

    (ROOT / "build").mkdir(exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="nccl-", dir=ROOT / "build"))
    out = {}
    distributed_init(f"file://{store / 'store'}", 1, 0, backend="nccl",
                     timeout=120)
    try:
        mesh = get_mesh("shard", device=dev)
        ntt = get_device_ntt(F.bn254_fr, dev)
        x = random_limbs(ntt.df, 1 << 17,
                         torch.Generator().manual_seed(SEED + 15))
        for name, fn, ref in (("sharded_ntt", ntt.sharded_ntt, ntt.ntt),
                              ("sharded_intt", ntt.sharded_intt, ntt.intt)):
            check(torch.equal(fn(x, mesh), ref(x)), f"{name} differs")
        out["ntt_equal"] = True

        g2_case = tiled_msm_case(dev, np.random.default_rng(SEED + 15),
                                 n=1 << 14, spec=C.bn254_g2)
        for tag, (dc, pts, S, want) in (("g1", case4), ("g2", g2_case)):
            t0 = time.perf_counter()
            got = sharded_msm(dc, pts, S, mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            dec = lambda p: dc.decode_points(tuple(a[None] for a in p))[0]
            check(dec(got) == want == dec(msm(dc, pts, S)),
                  f"sharded {tag} MSM differs from msm and the oracle")
            out[f"msm_{tag}"] = {"n": S.shape[0], "s": secs}

        g16, pk, cs, public = inner["key"]
        g16.set_mesh(mesh)
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            proof = g16.prove(pk, cs, r_rand=7, s_rand=11)
        finally:
            g16.set_mesh(None)
        out["prove_s"] = time.perf_counter() - t0
        out["steady_prove_s"] = c1["prove_s"]
        out["launches"] = {k.name: k.launches for k in kernels}
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        for k in kernels:
            check(k.launches > 0, f"{k.name} was not launched by the "
                  "sharded prove")
        want = inner["proof"]
        check((proof.a, proof.b, proof.c) == (want.a, want.b, want.c),
              "the sharded proof differs from phase 5's")
        check(g16.verify(inner["vk"], proof, public),
              "the sharded proof does not verify")
        check(not g16.verify(inner["vk"], proof, bumped(public, 0)),
              "the sharded proof verifies a tampered public input")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    say(f"[15b] world-size-1 NCCL: sharded NTT/iNTT at 2^17 equal, sharded "
        f"MSMs {out['msm_g1']} / {out['msm_g2']} equal; c1 with set_mesh in "
        f"{out['prove_s']:.3f} s (steady prove {out['steady_prove_s']:.3f} "
        f"s), equal to phase 5's proof, verified, tampered refused; "
        f"launches {out['launches']}, peak device memory "
        f"{out['peak_mem_gb']:.2f} GiB")
    return out


def c1_phase(dev, stages, kernels):
    """Phase 5: c1 built, set up, proved and verified on the card.
    Returns (its summary, c2's inner inputs: the proof with fixed
    randomness, the verifying key, the public inputs hash and the vote id,
    with the ballot's witness and the election's private key; the G2
    combine's recorded arguments)."""
    cs, public, build_s, bw, priv = ballot_circuit()
    c1 = groth16_phase(dev, cs, public, kernels, stages)
    c1["build_s"] = build_s
    horner_g2 = c1.pop("horner_g2_args")
    inner = {"proof": c1.pop("proof"), "vk": c1.pop("vk"),
             "inputs_hash": public[0], "vote_id": bw.vote_id,
             "ballot": bw, "priv": priv, "key": c1.pop("key")}
    say(f"[5] c1 summary {json.dumps(c1)}")
    return c1, inner, horner_g2


def c2_only():
    """Phases 5 and 10, then the sequencer's per-vote route: a committed
    prove through `prove_and_verify_committed` (one build more), two more
    steady reuse proves, and a second store on the same directory that
    must load with no setup, then prove and verify."""
    import tempfile

    import torch

    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch import log
    from davinci_tpu_torch.circuits.artifacts import ArtifactStore

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    device_line()
    build_phase([(src, limbs) for src in ("point_add", "bucket", "mont_mul")
                 for limbs in (22, 32)])
    stages = StageTimes()
    log.init()
    logging.getLogger("davinci").addHandler(stages)
    c1_kernels = [k for k in K.KERNELS if k.limbs == 22
                  and k not in K.B8.values()]
    _, inner, _ = c1_phase(dev, stages, c1_kernels)
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="store-", dir=ROOT / "build"))
    try:
        out, rt, cs, build, _, _ = c2_phase(stages, inner, root)
        public = cs.public_values()
        del cs
        built = []

        def build_once(challenge, blind):
            built.append(build(challenge, blind))
            return built[-1]

        t0 = time.perf_counter()
        rt.prove_and_verify_committed(build_once, public)
        out["first_prove_and_verify_s"] = time.perf_counter() - t0
        check(len(built) == 1, "the committed prove built c2 once")
        cs = built.pop()
        say(f"[10e] prove_and_verify_committed: "
            f"{out['first_prove_and_verify_s']:.3f} s (one build)")
        out["streaming"] = streaming_phase(rt, cs, stages)

        stages.took.clear()
        rt2 = ArtifactStore(root).load_or_setup(C2_ID, "bls12_377", cs)
        check("artifacts.load" in stages.took
              and "artifacts.setup" not in stages.took,
              "the second store loaded c2's key with no setup")
        out["second_store_load_s"] = stages.took["artifacts.load"]
        out["second_store"] = reuse_prove(rt2, cs, stages, "[10f]")[0]
        say(f"[10f] a second store loaded c2's key with no setup in "
            f"{out['second_store_load_s']} s, proved and verified")
    finally:
        shutil.rmtree(root)
    out["run_s"] = time.perf_counter() - t_run
    say(json.dumps({"c2": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def c3_only():
    """Phases 5 and 10, then the aggregator (c3) at full size, the
    sequencer's `VOTES_PER_BATCH` slots: the canonical dummy vote's c2
    proof [11e], phase 10's proof as the one real vote, the build [11b],
    setup on the card in memory [11c], `prove_and_verify` [11d] and one
    more prove [11f], each verified, then the key written through the
    store a section at a time [11c] (the host's resident set before, at
    its peak and after) and a second store on the same directory that
    must load it with no setup, prove and verify [11g] (no kernel
    replay).  From the setup on, the card's memory after each step
    (`card_memory`), by stage inside each prove, and the peak of each
    step on a line of its own."""
    import gc
    import tempfile

    import torch

    from davinci_tpu_torch import cuda_build
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch import log
    from davinci_tpu_torch import spec as protocol

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    device_line()
    build_phase([(src, limbs) for src in cuda_build.WIDE_SOURCES
                 for limbs in cuda_build.limbs_of(src)])
    stages = StageTimes()
    log.init()
    logging.getLogger("davinci").addHandler(stages)
    c1_kernels = [k for k in K.KERNELS if k.limbs == 22
                  and k not in K.B8.values()]
    _, inner, _ = c1_phase(dev, stages, c1_kernels)
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="store-", dir=ROOT / "build"))
    try:
        c2, c2_rt, c2_cs, _, c2_proof, c2_params = c2_phase(
            stages, inner, root, replay=False)
        say(f"[10] summary {json.dumps(c2)}")
        vote = (c2_proof, c2_cs.public_values()[0])
        del c2_cs
        dummy = c3_dummy(c2_rt, c2_params, inner, "[11e]")
        c2_vk = c2_rt.vk
        del c2_rt
        params, cs, out = c3_build(c2_vk, vote, dummy,
                                   protocol.VOTES_PER_BATCH, "[11b]")
        stages.mem = {}  # the card's memory by stage from here on
        rt, g16, pk, vk, out["in_memory"] = setup_in_memory(
            params, cs, stages, "[11c]")
        mem = out["card_memory"] = {
            "setup": card_memory("[11c]", "after setup", g16, pk, cs)}
        out["prove"] = [prove_verify(rt, cs, stages, "[11d]"),
                        prove_verify(rt, cs, stages, "[11f]")]
        mem["prove"] = card_memory("[11f]", "after the proves", g16, pk, cs)
        del rt
        gc.collect()
        rt, out["store"] = store_setup(params.circuit_id(), cs, root,
                                       stages, "[11c]", key=(g16, pk, vk))
        # the written key leaves the host before the second store reads it
        del rt, g16, pk, vk
        out["second_store"] = second_store(
            params.circuit_id(), cs, root, stages, "[11g]",
            lambda rt2: prove_verify(rt2, cs, stages, "[11g]"),
            curve="bw6_761", what="c3")
    finally:
        shutil.rmtree(root)
    out["card_peak_gib"] = {
        "setup": out["in_memory"]["setup_peak_mem_gib"],
        "proves": [p["peak_mem_gib"] for p in out["prove"]],
        "store_write": out["store"]["peak_mem_gib"],
        "store_load": out["second_store"]["load_peak_mem_gib"],
        "second_store_prove": out["second_store"]["prove"]["peak_mem_gib"]}
    say(f"[11g] c3 at {protocol.VOTES_PER_BATCH} slots, the card's peak of "
        f"each step, GiB: {json.dumps(out['card_peak_gib'])}")
    out["run_s"] = time.perf_counter() - t_run
    say(json.dumps({"c3": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def committed_only():
    """Phase 9 alone at c2's domain (2^22): committed-377 grown to 23,000
    products, set up on the card through the store, a first committed
    prove, one steady reuse prove and the second store's load and prove."""
    import torch

    from davinci_tpu_torch import log

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    device_line()
    build_phase([(src, limbs) for src in ("point_add", "bucket", "mont_mul")
                 for limbs in (22, 32)])
    stages = StageTimes()
    log.init()
    logging.getLogger("davinci").addHandler(stages)
    out, _, _ = committed_phase(dev, stages, COMMITTED_CHAIN_C2)
    out["run_s"] = time.perf_counter() - t_run
    say(json.dumps({"committed_c2_size": out}))
    return 0


def device_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)


def build_phase(targets=None):
    """Build the kernel libraries; ptxas's report of every kernel of
    them, {"kernel@L": "R registers, S bytes spilled"}."""
    from davinci_tpu_torch import cuda_build

    t0 = time.perf_counter()
    times = cuda_build.build_all(targets)
    build_s = time.perf_counter() - t0
    regs = {f"{name}@L{limbs}": usage
            for src, limbs in (targets or cuda_build.all_targets())
            for name, usage in ptxas_usage(cuda_build.ptxas_log(src, limbs))}
    say(f"[1] built {times} in {build_s:.3f} s; ptxas: {regs}")
    return regs


def g2_add_only():
    """Phase 3 alone, for the curves whose limb count has a B7 build."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.ec import get_device_curve

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device_line()
    build_phase([("point_add", limbs) for limbs in sorted(K.B7.builds)])
    names = [n for n in G2_CURVES
             if get_device_curve(getattr(C, n), dev).df.L in K.B7.builds]
    say(json.dumps({"g2_add": g2_add_phase(dev, names)}))
    return 0


def random_limbs(df, n, gen, below_p=True):
    """(n, L) int32 limbs on df's device from the torch generator `gen`:
    values below 2^(bits of p - 1) (so below p) or, with below_p false,
    any value below R (a raw operand)."""
    import torch

    L = df.L
    limbs = torch.randint(0, 1 << 12, (n, L), generator=gen)
    if below_p:
        limbs[:, -1] %= 1 << max(df.spec.p.bit_length() - 12 * (L - 1) - 1,
                                  0)
    return limbs.to(torch.int32).to(df.device)


def b1_b6_only():
    """B1 through the rows (`DeviceCurve.add`) and, where this checkout
    has the planes entry, on planes, at 45,056 and 2^16 adds on BN254 and
    BLS12-381 G1; B6 (`mont_mul`) at 2^16 on BN254 Fr and BLS12-381 Fp:
    event, device and host times per call.  Copied into a checkout of
    another commit, it times that commit's B1 and B6 at the same shapes."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import fields as F
    from davinci_tpu_torch.ec import cuda_add, get_device_curve
    from davinci_tpu_torch.ff import cuda_mul, get_device_field

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device_line()
    build_phase([(src, limbs) for src in ("point_add", "mont_mul")
                 for limbs in (22, 32)])
    rng = random.Random(SEED + 9)
    out = {"b1": {}, "b6": {}}
    for name in ("bn254_g1", "bls381_g1"):
        spec = getattr(C, name)
        dc = get_device_curve(spec, dev)
        pts, _ = random_points(dc, spec, 64, rng)
        for n in B1_SIZES[1:]:
            i = torch.arange(n, device=dev)
            p = tuple(a[i % 4096] for a in pts)
            q = tuple(torch.roll(a, 7, 0) for a in p)
            want = cuda_add.rcb15_plain(dc, p, q)
            check(max_err(dc.add(p, q), want) == 0, f"B1 rows on {name}")
            run = lambda: dc.add(p, q)
            rec = {"rows_ms": cuda_ms(run, 20),
                   # the rows' kernel: point_add_kernel before the
                   # planes entry, point_add_rows_kernel beside it
                   "rows_device_ms": device_ms(run, 20, "point_add")}
            if hasattr(cuda_add, "point_add_planes"):
                a, b = (tuple(x.T.contiguous() for x in t) for t in (p, q))
                run = lambda: cuda_add.point_add_planes(dc, a, b)
                check(max_err(tuple(x.T for x in run()), want) == 0,
                      f"B1 planes on {name}")
                rec.update(planes_ms=cuda_ms(run, 20),
                           planes_device_ms=device_ms(run, 20,
                                                      "point_add_kernel"))
            out["b1"][f"{name}@{n}"] = rec
            say(f"[b1] {name} n={n} {rec}")
    gen = torch.Generator().manual_seed(SEED)
    for name in ("bn254_fr", "bls12_381_fp"):
        df = get_device_field(getattr(F, name), dev)
        a, b = (random_limbs(df, 1 << 16, gen) for _ in range(2))
        run = lambda: cuda_mul.mont_mul(df, a, b)
        check(max_err(run(), cuda_mul.mont_mul_plain(df, a, b)) == 0,
              f"B6 on {name}")
        out["b6"][name] = {"ms": cuda_ms(run, 20),
                           "device_ms": device_ms(run, 20, "mont_mul_kernel"),
                           "host_us": host_us_per_call(run)}
        say(f"[b6] {name} {out['b6'][name]}")
    say(json.dumps(out))
    return 0


def b3_b8_only():
    """B3 at c1's shape and the blob's (Wt 22, NB 2,048 of random sums, on
    BN254 and BLS12-381 G1; contiguous buckets, which every checkout's
    wrapper takes) against its plain version: event and device times,
    ptxas's registers and spills; then phase 8 (B8 and B1 beside it).
    Copied into a checkout of another commit, it times that commit's B3
    and B8 at the same shapes."""
    import torch

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch.ec import get_device_curve
    from davinci_tpu_torch.msm import bucket_kernel as bk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device_line()
    regs = build_phase([("bucket", 22), ("bucket", 32), ("addk", 22),
                        ("point_add", 22)])
    rng = random.Random(SEED + 3)
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for name in ("bn254_g1", "bls381_g1"):
        spec = getattr(C, name)
        dc = get_device_curve(spec, dev)
        L = dc.df.L
        pts, _ = random_points(dc, spec, 8, rng)
        Wt, NB = 22, 2048
        idx = torch.randint(0, 64, (Wt * NB,), generator=gen).to(dev)
        buckets = tuple(a[idx].T.reshape(L, Wt, NB).contiguous() for a in pts)
        run = lambda: bk.bucket_reduce_kernel(dc, buckets)
        err = max_err(run(), bk._bucket_reduce_plain(dc, buckets,
                                                     bk.REDUCE_C))
        kernel = K.B3.at(L)
        check(err == 0, f"{kernel.name} differs from its plain version")
        out[kernel.name] = {
            "Wt": Wt, "NB": NB, "max_abs_err": err, "ms": cuda_ms(run, 20),
            "device_ms": device_ms(run, 20, "bucket_reduce_kernel"),
            "ptxas": regs[f"bucket_reduce_kernel@L{L}"]}
        say(f"[b3] {kernel.name} {out[kernel.name]}")
    addk_phase(dev)
    return 0


def main(argv) -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "davinci_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: davinci_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if argv == ["--g2-add"]:
        return g2_add_only()
    if argv == ["--b1-b6"]:
        return b1_b6_only()
    if argv == ["--b3-b8"]:
        return b3_b8_only()
    if argv == ["--c2-size"]:
        return committed_only()
    if argv == ["--c2"]:
        return c2_only()
    if argv == ["--c3"]:
        return c3_only()
    if argv[:1] == ["--c4"] and len(argv) <= 2:
        return c4_only(int(argv[1]) if argv[1:] else 60)
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    import numpy as np

    from davinci_tpu_torch import curves as C
    from davinci_tpu_torch import kernels as K
    from davinci_tpu_torch import log
    from davinci_tpu_torch.msm import pippenger

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    device_line()
    regs = build_phase()

    rng = random.Random(SEED)
    rng_np = np.random.default_rng(SEED)
    b8 = list(K.B8.values())  # the point-add experiment's path
    # c1's path
    kernels = [k for k in K.KERNELS if k.limbs == 22 and k not in b8]
    # the blob path: every L = 32 build but G2's, which 3b's MSM drives
    kernels32 = [k for k in K.KERNELS if k.limbs == 32
                 and k not in (K.B7_L32, K.B5G2_L32)]
    lap("[2]", t_run)
    b1 = {name: b1_phase(dev, name) for name in ("bn254_g1", "bls381_g1")}
    # the kernels line: B1 at the scan path's leftover merge, Wt x COLS
    res = {K.B1.name: b1["bn254_g1"]["planes"][B1_SIZES[1]]}
    g2_add = g2_add_phase(dev)
    # the kernels line: each build at the b2 MSM's accumulate launches
    res[K.B7.name] = g2_add["bn254_g2"][G2_SIZES[2]]
    res[K.B7_L32.name] = g2_add["bls377_g2"][G2_SIZES[2]]
    g2_msm, g2_horner_l32 = g2_msm_phase(dev, rng_np)
    say(f"[3b] BLS12-377 G2 MSM through msm equal to the host oracle: "
        f"{g2_msm}")

    lap("[4]", t_run)
    case = tiled_msm_case(dev, rng_np)
    say(f"[4a] fused G1 MSM equal to the host oracle: "
        f"{msm_phase(pippenger._msm_fused, case)}")
    with Capture() as cap:
        scan = msm_phase(pippenger._msm_scan, case)
    check(sorted(cap.calls) == sorted(Capture.WRAPPERS), "B2-B5 recorded")
    say(f"[4b] scan-path G1 MSM equal to the host oracle: {scan}")
    say(f"[4b] edge-case G1 MSM through msm: {edge_msm_phase(dev)}")
    res.update(scan_kernels_phase(cap.calls, regs))
    del cap  # phase 15 takes the case again

    stages = StageTimes()
    log.init()
    logging.getLogger("davinci").addHandler(stages)
    lap("[5]", t_run)
    c1, inner, horner_g2 = c1_phase(dev, stages, kernels)
    for args in (horner_g2, g2_horner_l32):  # c1's b2 sums, then 3b's
        name, out = g2_horner_phase(args, "[5b]")
        res[name] = out

    lap("[6]", t_run)
    b6 = mont_mul_phase(dev)
    res[K.B6.name] = b6["bn254_fr"]  # the c1 NTT's field
    res[K.B6_L32.name] = b6["bls12_381_fp"]  # the blob path's base field
    lap("[7]", t_run)
    blob, blob_res = blob_phase(dev, kernels32, rng, rng_np, regs)
    res.update(blob_res)
    say(f"[7] blob summary {json.dumps(blob)}")
    # phase 8 at the experiment's n alone: the default run's time goes to
    # phase 11 (`--b3-b8` runs phase 8 at both sizes)
    lap("[8]", t_run)
    addk_res, addk_launches = addk_phase(dev, ADDK_SIZES[:1])
    res.update(addk_res)
    lap("[11a]", t_run)
    res.update(l64_phase(dev, rng_np, regs))
    lap("[9]", t_run)
    committed, rt, lo = committed_phase(dev, stages)
    committed["kernels"] = committed_kernels_phase(rt, lo)
    del rt, lo
    committed["bls12_381"] = bls381_phase(dev)
    say(f"[9] summary {json.dumps(committed)}")
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="store-", dir=ROOT / "build"))
    try:
        lap("[13]", t_run)
        seq_out = sequencer_phase(stages, inner, root)
        say(f"[13] summary {json.dumps(seq_out)}")
        lap("[14]", t_run)
        cli_out = cli_phase(stages, root, seq_out)
    finally:
        shutil.rmtree(root)
    say(f"[14] summary {json.dumps(cli_out)}")
    lap("[15]", t_run)
    last = {"poseidon": poseidon_phase(dev),
            "mesh": mesh_phase(dev, c1, inner, case, kernels)}
    say(f"[15] summary {json.dumps(last)}")

    say(f"whole run: {time.perf_counter() - t_run:.1f} s")
    # every kernel is on the node's path (phases 13 and 14) but B8's,
    # which phase 8's experiment launches
    launches = {**addk_launches}
    for path in (seq_out, cli_out):
        for name, n in path["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for k in K.KERNELS:
        check(launches.get(k.name, 0) > 0,
              f"{k.name} was not launched by its path")
    say(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "limbs": k.limbs,
         "launches": launches[k.name],
         **{key: res[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "ptxas": regs[f"{kernel_function(k)}@L{k.limbs}"]}
        for k in K.KERNELS
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
