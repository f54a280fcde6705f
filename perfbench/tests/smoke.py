"""Cells of BENCHMARK.json at the program's smoke sizes, for the CPU tests:
the configuration's fields from the program's registered smoke config of
its `arch`, the traffic shrunk (same kind, same shape of mix)."""
from __future__ import annotations

import io
import json
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_TRAFFIC = {
    "mtsl_train": {"seq_len": 32, "data_vocab": 64, "profiled_s": 0.01},
}


def workloads() -> list:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def cell(name: str, dtype: str = "float32") -> dict:
    from perfbench.lib import bench
    from repro_torch.configs import get_config

    w = bench.cell(name)
    sm = get_config(w["cfg"]["arch"], smoke=True)
    w["cfg"] = dict(w["cfg"], **{k: getattr(sm, k) for k in bench.MODEL_FIELDS})
    w["cfg"]["dtype"] = dtype
    if w["cfg"]["family"] == "moe":
        w["cfg"]["capacity_factor"] = 1.25  # drops rows, as the cell does
    kind = w["traffic_spec"]["kind"]
    w["traffic_spec"] = dict(w["traffic_spec"], **SMOKE_TRAFFIC[kind])
    return w


def run(w: dict, seed: int = 2**31 + 7, seconds: float = 0.5, trace: bool = False):
    """(exit code, the last line of standard output parsed, standard error)."""
    import torch

    from perfbench.lib import result

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out), redirect_stderr(err):
        rc = result.emit(w, seed, seconds, trace, torch.device("cpu"),
                         lambda: time.perf_counter() - t0)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()
