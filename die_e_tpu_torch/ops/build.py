"""Build the port's CUDA sources with one ``nvcc`` call each and load them
with ``ctypes``.

Each source under ``ops/csrc/`` has a plain C interface (no PyTorch
headers), so a build takes seconds.  The shared library goes to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source builds
anew and a built one is reused.  Nothing is built when a module is
imported: the wrappers build at their first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


@functools.cache
def build(source: str) -> dict:
    """Compile ``csrc/<source>`` into a shared library (once per process,
    and not at all when an identical build exists).  Returns ``{"path",
    "seconds", "ptxas"}``: the library, the build's wall time (0 when
    reused) and the ``-Xptxas -v`` lines on registers and shared memory."""
    src = CSRC / source
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{src.stem}-{tag.hexdigest()[:16]}.so"
    if lib.exists():
        return {"path": lib, "seconds": 0.0, "ptxas": []}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent reader sees all or nothing
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "ptxas info" in ln and ("registers" in ln or "Function properties" in ln
                                        or "Compiling entry" in ln)]
    return {"path": lib, "seconds": seconds, "ptxas": ptxas}


@functools.cache
def load(source: str, signatures: tuple) -> ctypes.CDLL:
    """Build ``source`` and load it, declaring each ``(name, argtypes)`` of
    ``signatures``: pointers and the stream are ``c_void_p``, ints
    ``c_int``, and every function returns a ``cudaError_t`` as ``c_int``."""
    lib = ctypes.CDLL(str(build(source)["path"]))
    for name, argtypes in signatures:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
