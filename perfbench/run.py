"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one run
of one cell, as `BENCHMARK.json` names it.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

prints, as the last line of its standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, and with --trace 1 the trace's
breakdown; every number that decides `correct` is printed beside its
limit, last on standard error and under "compared" in that line.

It runs on the card of the machine it is started on and refuses to run
without one. Nothing it loads may be JAX or the reference package
`repro`: it checks sys.modules once the window has closed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STARTED = time.perf_counter()


def _since_process_start() -> float:
    """Seconds since this process began (its start time from /proc), or
    since this file was first run where /proc has no record."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / ticks
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - STARTED


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the program's own nvcc builds already go
    to build/repro_torch/)."""
    build = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.lib import bench, result

    w = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"perfbench: {w['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    return result.emit(w, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), _since_process_start)


if __name__ == "__main__":
    sys.exit(main())
