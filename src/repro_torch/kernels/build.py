"""Build and load the port's CUDA C++ kernels (nvcc + ctypes).

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, ``build/repro_torch/libkernels.so`` at
the root of the checkout, and loaded with :mod:`ctypes`.  The build runs
at first use (or when a source is newer than the library) and never when a
module is imported: hosts without a card or ``nvcc`` import the package
freely.  Triton's compile cache is pointed into the same directory, so
the package writes nothing outside its checkout.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/repro_torch (this file is <checkout>/src/repro_torch/kernels)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "libkernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """The CUDA C++ sources compiled into the library."""
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc`` first)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only on a host with "
            "the CUDA toolkit (set CUDA_HOME)")
    return found


def stale() -> bool:
    """True when the library is missing or older than a source."""
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_library(extra_flags: Optional[List[str]] = None) -> str:
    """Compile every source into :data:`LIBRARY`; returns nvcc's output.

    Each source compiles to an object of its own in parallel, then one
    ``nvcc -shared`` links them.  The library is written to a temporary
    name and renamed into place, so a concurrent reader never loads a
    half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / (src.stem + ".o")) for src in sources()]
        compiles = [[nvcc(), *NVCC_FLAGS, *(extra_flags or []), "-c",
                     str(src), "-o", obj]
                    for src, obj in zip(sources(), objs)]
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            logs = list(pool.map(_run, compiles))
        lib = str(Path(tmpdir) / LIBRARY.name)
        logs.append(_run([nvcc(), *ARCH_FLAGS, "-shared", "-o", lib, *objs]))
        os.replace(lib, LIBRARY)
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first when stale.

    Declares the argument types of every C entry point: pointers and the
    stream as ``c_void_p`` (a bare Python int would be cut to 32 bits).
    """
    global _lib
    if _lib is None:
        if stale():
            build_library()
        lib = ctypes.CDLL(str(LIBRARY))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_attention.argtypes = [p, p, p, p, p, p,
                                              i, i, i, i, i, i, i, i, p]
        lib.repro_paged_attention.restype = i
        lib.repro_flash_attention_fwd.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.repro_flash_attention_fwd.restype = i
        lib.repro_flash_attention_bwd.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.repro_flash_attention_bwd.restype = i
        lib.repro_mamba_scan.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.repro_mamba_scan.restype = i
        lib.repro_slstm_scan.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.repro_slstm_scan.restype = i
        _lib = lib
    return _lib


def triton_cache_dir() -> str:
    """Triton's compile cache for the port's Triton kernels."""
    return str(BUILD_DIR / "triton")
