"""What every cell shares: finding a cell's files by the names in
`BENCHMARK.json`, the program's configuration built from a configuration
file, the per-layer metric readers, and the result line.

A cell names a configuration and a traffic mix. The configuration is
`perfbench/configs/<config>.json` (the program's registered config
`arch` with every field the run uses; the reference reads the same
file); the traffic is `perfbench/traffic/<traffic>.json`, whose `kind`
picks the driver (`perfbench/lib/<kind>.py`, with `run(...)`); the
limits that decide `correct` are `perfbench/limits/<workload>.json`; a
per-layer metric is read by `perfbench/metrics/<metric>.py::read(ctx)`,
which returns a number or None when the cell gives it nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
# the reference package, the JAX libraries: none may be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(workload: str, bench: Optional[dict] = None) -> dict:
    """The workload entry, with its configuration, traffic and limits."""
    bench = bench or benchmark()
    match = [w for w in bench["workloads"] if w["name"] == workload]
    if not match:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = dict(match[0])
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    w["cfg"] = load_json(ROOT / conf["file"])
    w["traffic_spec"] = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    w["limits"] = load_json(HERE / "limits" / f"{workload}.json")
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if workload in m.get("workloads", [workload])]
    return w


# ModelConfig fields a configuration file may set (the rest describe the
# file: its source, cuts and assumptions)
MODEL_FIELDS = (
    "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
    "d_ff", "vocab_size", "norm_eps", "rope_theta", "num_experts",
    "experts_per_token", "num_shared_experts", "moe_d_ff", "first_dense_layers",
    "capacity_factor", "router_aux_weight", "moe_groups", "ssm_state",
    "ssm_expand", "ssm_headdim", "ssm_conv_width", "ssm_chunk",
    "shared_attn_every", "split_layers", "dtype", "param_dtype", "remat",
    "scan_layers", "attn_impl")


def model_config(cfg: dict):
    """The program's ModelConfig for a configuration file: its registered
    `arch` with every field the file sets."""
    from repro_torch.configs import get_config

    return get_config(cfg["arch"]).with_updates(
        **{k: cfg[k] for k in MODEL_FIELDS if k in cfg})


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(w: dict, ctx) -> Dict[str, dict]:
    out = {}
    for m in w["per_layer"]:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def driver(kind: str):
    return importlib.import_module(f"perfbench.lib.{kind}")


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))
