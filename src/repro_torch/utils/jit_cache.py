"""The persistent build cache of the port's kernels (counterpart of
`repro.utils.jit_cache`, which turns on JAX's compilation cache).

The port compiles only its CUDA kernels, each into a shared library named
by a hash of its flags, sources and headers (`kernels/build.py`). By
default they land in `build/repro_torch/` of the checkout, so a fresh
checkout builds them anew. `enable_compilation_cache(path)` points the
builds at `path`, or at the directory in the environment variable
REPRO_TORCH_KERNEL_CACHE when `path` is None, so that a second checkout
(or a second run from a fresh `git archive`) loads the libraries built
before. A library is only reused when its hash matches, so an edited
source is built again.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_VAR = "REPRO_TORCH_KERNEL_CACHE"


def enable_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernels' builds at `path` (or $REPRO_TORCH_KERNEL_CACHE).

    Returns the directory in use, or None when neither names one (the
    builds then stay where they were). Safe to call repeatedly; the
    directory is made on the first build."""
    from repro_torch.kernels import build

    path = path or os.environ.get(ENV_VAR)
    if not path:
        return None
    build.BUILD_DIR = Path(path).expanduser().resolve()
    return str(build.BUILD_DIR)
