"""Dry-run on the meta device (port of `repro.launch.dryrun`): run one
program (train step, prefill step or decode step) of every architecture
x input shape for one rank of a mesh, on tensors with shapes and dtypes
and no storage, and report what it costs that rank and whether it fits
one card, without a card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.json

The mesh (`--mesh`, default "data=16,model=16", the reference's 16
clients; `--multi-pod` is "pod=2,data=16,model=16") is taken as axis
sizes: no ranks are started. A rank holds its M/D clients' towers and
their optimizer state, the whole server (replicated, as
`core.algorithms.place_algorithm_state` places it) and its rows of the
batch or the caches (D the mesh's client-shard count, "pod" x "data").
Where M is smaller than D (long_500k serves one client) every rank
holds the whole of it: the port shards no sequence. The train step's
cross-client collectives go over a client group of D ranks with no
process group behind it (`utils.collectives.DryRunGroup`), which records
them.

A report carries the reference's keys where they mean something here:
`flops` (torch's flop counter over every op: the matrix products,
convolutions and attentions; elementwise work is not counted) plus the
kernels' cost models, `bytes_accessed` (eager's unfused traffic: every
op's inputs and outputs once, plus the kernels' cost models),
`collective_bytes` and `collectives` ({kind: [calls, bytes]}),
`argument_size_in_bytes` (the program's inputs), `output_size_in_bytes`
(new storage among its outputs) and `temp_size_in_bytes` (the rest of
the peak). It adds `peak_bytes` (live tensor bytes through the program,
arguments included), the launches of K1-K4 (their wrappers take meta
tensors as an explicit request: `kernels.counts.META`), and
`fits_one_h100` (peak_bytes within the card's memory: the card's own
total on a card, `launch.hardware.MEMORY_BYTES` under `--device cpu`).
Not fitting is a field, not a failure.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import client_axis
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.core.schedule import full_schedule, local_schedule
from repro_torch.kernels.counts import META
from repro_torch.launch import specs
from repro_torch.launch.hardware import memory_bytes
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.models.registry import build_model, stack_kinds
from repro_torch.nn.init import abstract_params
from repro_torch.optim import adamw, sgd
from repro_torch.serve.engine import build_decode_step, build_prefill_step
from repro_torch.utils import collectives
from repro_torch.utils.sharding import client_axis_size
from repro_torch.utils.tree import tree_bytes, tree_map_with_path

ASSIGNED = [
    "gemma3-12b",
    "llama-3.2-vision-11b",
    "deepseek-7b",
    "mamba2-130m",
    "deepseek-moe-16b",
    "qwen3-moe-30b-a3b",
    "whisper-tiny",
    "mistral-large-123b",
    "zamba2-7b",
    "mistral-nemo-12b",
]
DEFAULT_MESH = "data=16,model=16"
MULTI_POD_MESH = "pod=2,data=16,model=16"
# the kernels' wrappers, by the name each records in META
KERNELS = {"k1": "mtsl_update_multi_", "k2": "flash_attention", "k3": "ssd_scan",
           "k4": "flash_decode"}
# ops that move no bytes: allocations (a kernel's meta outputs among them)
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default, torch.ops.aten.lift_fresh.default}

# (K2 causal, K2 non-causal self, K2 cross, K3) launches of one block's
# forward, by kind
_BLOCK_LAUNCHES = {"full": (1, 0, 0, 0), "swa": (1, 0, 0, 0),
                   "dense_moe_lead": (1, 0, 0, 0), "moe": (1, 0, 0, 0),
                   "bidir": (0, 1, 0, 0), "cross": (1, 0, 1, 0),
                   "mamba": (0, 0, 0, 1), "shared_attn": (1, 0, 0, 1)}


def launches_per_round(cfg, M: int, microbatches: int = 1, local_steps: int = 1,
                       full_models: bool = False) -> dict:
    """K2 (all, and the non-causal self and cross ones apart) and K3
    launches one training round makes, from each stack's block kinds
    (`models.registry.stack_kinds`): the towers run once per client and
    local step, the server once per step (mtsl, splitfed: the clients'
    smashed data folds into one batch) or once per client and step
    (`full_models`: fedavg's per-client full models); under remat every
    unit's forward runs again in the backward."""
    remat = 1 if cfg.remat == "none" else 2
    n = remat * microbatches * local_steps
    tot = [0, 0, 0, 0]
    for (side, _), kinds in stack_kinds(cfg).items():
        times = M if side == "tower" or full_models else 1
        for kind in kinds:
            for i, c in enumerate(_BLOCK_LAUNCHES[kind]):
                tot[i] += n * times * c
    causal, bidir, cross, k3 = tot
    return {"k2": causal + bidir + cross, "k2_bidir": bidir, "k2_cross": cross,
            "k3": k3}


class ProgramTrace(TorchDispatchMode):
    """Counts every op a program runs: FLOPs (torch's flop counter),
    bytes (each op's tensor inputs and outputs, views and allocations
    aside) and live tensor bytes, storage by storage, with their peak.
    `arguments` are the program's inputs: their storages are live from
    the start."""

    def __init__(self, arguments):
        super().__init__()
        self.flops = self.bytes = self.live = self.peak = 0
        self._sizes = {}  # id(storage) -> bytes, while it lives
        self.argument_bytes = self._track(arguments)

    def _track(self, tree) -> int:
        new = 0
        for t in tree_flatten(tree)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            new += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return new

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        self._track(out)
        return out


def _to_meta(tree):
    """Every tensor of a state on the meta device (an init draws its few
    non-parameter tensors, such as FedEM's mixture weights, on the
    generator's device)."""
    return tree_map_with_path(
        lambda _, x: x.to("meta") if torch.is_tensor(x) and not x.is_meta else x, tree)


def _rank_inputs(cfg, kind: str, rows: int, b: int, S: int) -> dict:
    """A rank's meta inputs: `rows` clients of b rows (`specs.input_specs`'
    leaves), tokens as int64, the port's token dtype (the specs give the
    reference's int32); a classifier's images and labels."""
    if cfg.family in ("mlp", "resnet"):
        return {"image": torch.empty((rows, b, cfg.image_size, cfg.image_size,
                                      cfg.image_channels), device="meta"),
                "label": torch.empty((rows, b), dtype=torch.int32, device="meta")}
    inputs, _ = specs.input_specs(cfg, ShapeConfig(kind, S, rows * b, kind),
                                  {"data": rows})
    return {k: v.long() if k == "tokens" else v for k, v in inputs.items()}


def run_program(model, kind: str, M: int, b: int, S: int, *, shards: int = 1,
                optimizer=None, algorithm: str = "mtsl", component_lr=None,
                lr: float = 1e-4, local_steps: int = 1, device=None) -> dict:
    """Run one program of `model` on meta tensors for one rank of a mesh
    with `shards` client shards: "train" (one round of `algorithm`
    through the registry, `optimizer` and `component_lr` in its
    HParams), "prefill" (S tokens) or "decode" (one step at the last
    position of an S-row cache). M clients of b rows in all. Returns the
    report's measured keys (see the module docstring)."""
    cfg = model.cfg
    D = shards if M % shards == 0 else 1  # fewer clients than shards: replicated
    rank_M = M // D
    group = collectives.dry_run_client_group(D) if D > 1 else None
    client_axis.reset_collectives()
    META.reset()
    cap = memory_bytes(device)
    t0 = time.perf_counter()
    extra = {}
    if kind == "train":
        alg = get_algorithm(algorithm)
        if optimizer is None:
            optimizer = sgd(0.05) if cfg.family in ("mlp", "resnet") else adamw(lr)
        hp = HParams(lr=lr, local_steps=local_steps, optimizer=optimizer,
                     component_lr=component_lr, microbatches=cfg.microbatches)
        with abstract_params():
            state = _to_meta(alg.init_state(model, torch.Generator(), rank_M, hp))
        round_fn = alg.round_fn(model, M, hp)
        spr = alg.steps_per_round(hp)
        batch = _rank_inputs(cfg, "train", rank_M, b * spr, S)  # b rows a step
        sched = local_schedule(full_schedule(M, spr), slice(0, rank_M))
        if hasattr(state, "params"):  # mtsl's TrainState: the state's bytes
            extra = {"param_bytes": tree_bytes(state.params),
                     "opt_state_bytes": sum(x.numel() * x.element_size()
                                            for x in tree_flatten(state.opt_state)[0]
                                            if torch.is_tensor(x))}
        arguments = (state, batch)
        ctx = (client_axis.client_axis(group=group) if group is not None
               else contextlib.nullcontext())
        with ctx, ProgramTrace(arguments) as tr:
            out = round_fn(state, batch, sched)
        del state
    else:
        params, _ = specs.abstract_mtsl_params(model, rank_M, serving=True)
        inputs = _rank_inputs(cfg, kind, rank_M, b, S)
        with torch.no_grad():
            if kind == "prefill":
                step = build_prefill_step(model, rank_M, max_len=S)
                arguments = (params, inputs)
                with ProgramTrace(arguments) as tr:
                    out = step(params, inputs)
            else:
                caches, _ = specs.abstract_caches(
                    model, ShapeConfig(kind, S, rank_M * b, kind), {"data": rank_M})
                caches = specs.tower_caches(caches, rank_M)
                step = build_decode_step(model, rank_M)
                arguments = (params, caches, inputs["tokens"])
                with ProgramTrace(arguments) as tr:
                    out = step(params, caches, inputs["tokens"], S - 1)
    run_s = time.perf_counter() - t0
    out_bytes = tr._track(out)  # new storage among the outputs
    ops = group.group.ops if group is not None else []
    stats = collectives.collective_bytes(ops)
    kern = {k: dict(META.by_kernel.get(name, {"launches": 0, "flops": 0, "bytes": 0,
                                             "workspace_bytes": 0, "leaves": 0,
                                             "by_key": {}}))
            for k, name in KERNELS.items()}
    kflops = sum(v["flops"] for v in kern.values())
    kbytes = sum(v["bytes"] for v in kern.values())
    return {
        "num_clients": M, "batch_per_client": b, "rank_clients": rank_M,
        "client_shards": D, "seq_len": S,
        "flops": float(tr.flops + kflops), "bytes_accessed": float(tr.bytes + kbytes),
        "collective_bytes": stats.total_bytes,
        "collectives": {k: [stats.count_by_kind[k], v]
                        for k, v in stats.bytes_by_kind.items()},
        "collective_ops": ops,
        "argument_size_in_bytes": tr.argument_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(tr.peak - tr.argument_bytes - out_bytes, 0),
        "peak_bytes": tr.peak, "capacity_bytes": cap, "fits_one_h100": tr.peak <= cap,
        "launches": {k: v["launches"] for k, v in kern.items()},
        "k1_leaves": kern["k1"]["leaves"], "kernels": kern,
        "run_s": run_s, **extra,
    }


def lower_program(arch: str, shape_name: str, *, mesh: Optional[str] = None,
                  multi_pod: bool = False, algorithm: str = "mtsl",
                  overrides: Optional[dict] = None, verbose: bool = True,
                  top_collectives: int = 0, device=None):
    """Dry-run one (arch, shape, mesh): the report dict (status OK or
    SKIPPED; an exception is the caller's FAILED)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_updates(**overrides)
    spec = mesh or (MULTI_POD_MESH if multi_pod else DEFAULT_MESH)
    sizes = parse_mesh_spec(spec)
    mesh_name = "x".join(str(v) for v in sizes.values())
    if shape.kind == "decode" and shape.seq_len > 131_072 \
            and not specs.long_context_supported(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "SKIPPED",
                "reason": "full-attention arch; no sub-quadratic variant (DESIGN.md §6)"}
    M, b = specs.clients_for(shape, sizes)
    D = client_axis_size(sizes)
    got = run_program(build_model(cfg), shape.kind, M, b, shape.seq_len, shards=D,
                      algorithm=algorithm, device=device)
    ops = got.pop("collective_ops")
    report = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "algorithm": algorithm if shape.kind == "train" else "-",
              "status": "OK", **got}
    if top_collectives:
        report["top_collectives"] = collectives.top_collectives(ops, top_collectives)
    if verbose:
        gib = 2 ** 30
        print(f"== {arch} x {shape_name} ({mesh_name}) : {report['status']}")
        print(f"   clients={M} b={b} (this rank {report['rank_clients']}) "
              f"run={report['run_s']:.1f}s")
        print(f"   memory: peak {report['peak_bytes'] / gib:.2f} GiB (arguments "
              f"{report['argument_size_in_bytes'] / gib:.2f}, output "
              f"{report['output_size_in_bytes'] / gib:.2f}, temp "
              f"{report['temp_size_in_bytes'] / gib:.2f}); fits one H100 "
              f"{report['fits_one_h100']}")
        print(f"   cost: flops={report['flops']:.3e} bytes={report['bytes_accessed']:.3e}"
              f"  launches {report['launches']}")
        print("   collectives:")
        print(collectives.collective_bytes(ops).summary())
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help=f"axis sizes, e.g. {DEFAULT_MESH} (the default)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--algorithm", default="mtsl",
                    choices=["mtsl", "splitfed", "fedavg"])
    ap.add_argument("--json", default=None, help="write reports to this file")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value (e.g. fsdp=False)")
    ap.add_argument("--device", default="cuda",
                    help="the card whose memory a program must fit (cuda), or "
                         "cpu: the H100's capacity from launch/hardware.py")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device; pass --device cpu to check "
                         "against the H100's capacity without a card")

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v.lower()) if v.lower() in ("true", "false") else (
            int(v) if v.isdigit() else v)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([DEFAULT_MESH, MULTI_POD_MESH] if args.both_meshes
              else [args.mesh or (MULTI_POD_MESH if args.multi_pod else DEFAULT_MESH)])

    reports = []
    for spec in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    r = lower_program(arch, shape, mesh=spec, algorithm=args.algorithm,
                                      overrides=overrides or None, device=device)
                except Exception as e:  # noqa: BLE001 — report and continue
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape, "mesh": spec,
                         "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                reports.append(r)
    ok = sum(r["status"] == "OK" for r in reports)
    skip = sum(r["status"] == "SKIPPED" for r in reports)
    fail = sum(r["status"] == "FAILED" for r in reports)
    print(f"\n=== dry-run summary: {ok} OK, {skip} SKIPPED, {fail} FAILED "
          f"of {len(reports)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
