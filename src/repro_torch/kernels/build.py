"""Builds the port's CUDA sources with `nvcc` into shared libraries with a
plain C interface, loaded through `ctypes`.

A library is built on first use, for `sm_90a` (Hopper), into
`build/repro_torch/` at the root of the checkout. Its file name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded; a header that a source includes enters the hash
too, when the caller names it. Nothing here runs when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ptxas's report (registers, shared memory, spills) of each library, by
# name: written beside the library when it is built, read back when a
# cached library is loaded
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> Path:
    """Where the library built from `sources` lives: its name carries a
    hash of the flags, the sources and every header they include (the
    headers are named by the caller; nvcc does not report them), so an
    edit to any of them gives a new path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*sources, *headers):
        h.update(Path(f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_cuda_library(name: str, sources: Sequence[Path],
                      headers: Sequence[Path] = ()) -> ctypes.CDLL:
    """Build (if needed) and load `lib<name>-<hash>.so` from `sources`,
    which include `headers`. Callers cache the handle (and set its
    argtypes) once."""
    lib_path = library_path(name, sources, headers)
    log_path = lib_path.with_suffix(".ptxas.txt")
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        # the report first: a library on disk always has its report beside it
        log_path.write_text(proc.stderr)
        os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    BUILD_LOGS[name] = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(lib_path))
