"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded through ctypes.  A library is
named by a hash of the sources, built at first use into
`build/davinci_tpu_torch/` at the repository root, and reused while the
sources are unchanged.  `build_all` starts one nvcc per source, all at
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "davinci_tpu_torch"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
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


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def ptxas_log(name: str) -> Path:
    """nvcc's -Xptxas -v report (registers, spills) of the last build."""
    return BUILD_DIR / f"{name}-{_digest()}.ptxas.txt"


def build_all(names=None) -> dict[str, float]:
    """Compile the named sources (default: every csrc/*.cu) that are not
    built yet, one nvcc process per source started together.  Returns
    {name: seconds}; raises RuntimeError with nvcc's output on failure."""
    if names is None:
        names = sorted(f.stem for f in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, time.perf_counter())
    times, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():  # wait for every nvcc
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        ptxas_log(name).write_text(log)
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
