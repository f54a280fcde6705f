"""A run's result line: the driver's numbers, `correct` from the limits of
the cell (`perfbench/limits/<workload>.json`), the device, and every
number compared beside its limit (last on standard error, and last in the
line under "compared")."""
from __future__ import annotations

import json
import sys

from perfbench.lib import bench


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for the numbers the limits
    name; a number missing or not finite is not correct."""
    compared, correct = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, {}).get("value")
        ok = v is not None and v == v and v <= limit
        correct = correct and ok
        compared[name] = {"value": v, "limit": limit}
    return correct, compared


def emit(w: dict, seed: int, seconds: float, trace: bool, device, started) -> int:
    import torch

    out = bench.driver(w["traffic_spec"]["kind"]).run(w, seed, seconds, trace, device,
                                                      started)
    found = bench.loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {found}, which no run may load", file=sys.stderr)
        return 3
    correct, compared = judge(out["numbers"], w["limits"]["limits"])
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(out["peak"])}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": dev}
    if trace:
        tr = out["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        from perfbench.lib.trace import breakdown

        line["breakdown"] = breakdown(tr)
    line["compared"] = compared
    for name, c in compared.items():
        extra = {k: v for k, v in out["numbers"].get(name, {}).items() if k != "value"}
        print(f"{name} {c['value']!r} limit {c['limit']!r} {json.dumps(extra)}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
