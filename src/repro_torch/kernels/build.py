"""Build and load the hand-written CUDA kernels at first use.

Each source under kernels/csrc/ is compiled by `nvcc` for `sm_90a` into
a shared library with a plain C interface, loaded with ctypes.  The
library lands in kernels/_build/ (listed in .gitignore) under a name
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing is compiled
when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# every kernel source under csrc/
SOURCES = ("pdhg_burst.cu", "pdhg_coo.cu", "flash_attention.cu",
           "rglru_scan.cu")
# per-source flags; a source not listed builds with NVCC_FLAGS.  The PDHG
# bursts (ELL and COO) keep -fmad=false (each product rounded, as in their
# plain versions; the COO kernel writes its two contracted updates as
# explicit fused multiply-adds); attention wants fused multiply-adds,
# which only make it more exact.
SOURCE_FLAGS = {
    "flash_attention.cu": tuple(f for f in NVCC_FLAGS if f != "-fmad=false"),
}

# one lock per source: two threads may build two sources at once
_LOCKS: dict[str, threading.Lock] = {}
_LOADED: dict[str, ctypes.CDLL] = {}
# per source: seconds the build took in this process (0.0 when a built
# library was found) and the compiler's output (-Xptxas -v: registers,
# shared memory and spills per kernel)
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc.  Raises RuntimeError when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("no nvcc found (set CUDA_HOME); the CUDA kernels are "
                       "built from kernels/csrc at first use on the card")


def load(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` if its library is not built yet, then load
    it (once per process)."""
    with _LOCKS.setdefault(source, threading.Lock()):
        lib = _LOADED.get(source)
        if lib is not None:
            return lib
        src = CSRC / source
        flags = SOURCE_FLAGS.get(source, NVCC_FLAGS)
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(flags).encode()).hexdigest()
        out = BUILD_DIR / f"{src.stem}_{digest[:16]}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *flags, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, out)
        BUILD_INFO[source] = {"seconds": time.perf_counter() - t0,
                              "log": log, "library": str(out)}
        lib = ctypes.CDLL(str(out))
        _LOADED[source] = lib
        return lib
