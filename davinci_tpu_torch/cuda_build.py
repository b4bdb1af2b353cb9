"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into one shared
library with a plain C interface per limb count in `LIMBS`, and at
`WIDE_LIMBS` (BW6-761's 64) for the sources in `WIDE_SOURCES` (the field
core `csrc/field.cuh` is a template on L; `-DDAVINCI_L` picks the
instantiation), loaded through ctypes.  A library is named by its source,
its L and a hash of the sources, built at first use into
`build/davinci_tpu_torch/` at the repository root, and reused while the
sources are unchanged.  `build_all` starts one nvcc per library, all at
once.  Nothing here runs at import: this module imports on machines
without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "davinci_tpu_torch"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIMBS = (22, 32)  # 12-bit limbs per field element the kernels are built for
# BW6-761's Fp: only the sources of its path (B1, B2-B5, B6) are built at
# 64; B7 and B5's G2 build serve Fp2, and no Fp2 curve has L = 64 (their
# code is left out of that build), B8 is BN254 only
WIDE_LIMBS = 64
WIDE_SOURCES = ("point_add", "bucket", "mont_mul")

_libs: dict[tuple[str, int], ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, limbs: int) -> Path:
    return BUILD_DIR / f"{name}-L{limbs}-{_digest()}.so"


def ptxas_log(name: str, limbs: int) -> Path:
    """nvcc's -Xptxas -v report (registers, spills) of the last build."""
    return BUILD_DIR / f"{name}-L{limbs}-{_digest()}.ptxas.txt"


def limbs_of(name: str) -> tuple[int, ...]:
    """The limb counts csrc/<name>.cu is built for."""
    return LIMBS + ((WIDE_LIMBS,) if name in WIDE_SOURCES else ())


def all_targets() -> list[tuple[str, int]]:
    """(source stem, L) of every library: each csrc/*.cu at each of its
    limb counts."""
    return [(f.stem, limbs) for f in sorted(CSRC.glob("*.cu"))
            for limbs in limbs_of(f.stem)]


def build_all(targets=None) -> dict[str, float]:
    """Compile the (name, L) libraries (default: `all_targets()`) that are
    not built yet, one nvcc process each, started together.  Returns
    {"name@L": seconds}; raises RuntimeError with nvcc's output on
    failure."""
    if targets is None:
        targets = all_targets()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, limbs in targets:
        out = library_path(name, limbs)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, f"-DDAVINCI_L={limbs}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[(name, limbs)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, time.perf_counter())

    def finish(proc):  # nvcc's output and the moment it ended
        log, _ = proc.communicate()
        return log, time.perf_counter()

    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        ends = {key: pool.submit(finish, proc)
                for key, (proc, _, _) in procs.items()}
    times, failed = {}, []
    for (name, limbs), (proc, tmp, t0) in procs.items():
        log, t1 = ends[(name, limbs)].result()
        times[f"{name}@L{limbs}"] = t1 - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu at L={limbs}:\n{log}")
            continue
        ptxas_log(name, limbs).write_text(log)
        os.replace(tmp, library_path(name, limbs))
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str, limbs: int) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu built for L = `limbs`, built
    first if needed."""
    with _lock:
        lib = _libs.get((name, limbs))
        if lib is None:
            build_all([(name, limbs)])
            lib = _libs[(name, limbs)] = ctypes.CDLL(
                str(library_path(name, limbs)))
        return lib
