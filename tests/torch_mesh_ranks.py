"""Spawned gloo ranks for the port's mesh tests (tests/test_torch_mesh_*.py).

`spawn(world, task, tmp)` starts `world` processes that join one gloo
world through a `file://` rendezvous under `tmp` (so concurrent test
workers never share a port), wait for the payload the parent sends, run
`TASKS[task](rank, world, payload)`, and return what the first rank
returned. The processes import torch and the
port only, never jax or `repro`: the parent computes the reference's side
and hands the children what they need (states as the port's tensors,
batches as numpy) in `payload`.
"""
from __future__ import annotations

import copy
import os
import pickle
import traceback

import numpy as np
import torch

ROUNDS_ALGS = ("fedavg", "fedem", "fedprox", "mtsl", "parallelsfl", "smofi",
               "splitfed")


def flat_state(state, prefix: str = "") -> dict:
    """{path: numpy array} of a state (dicts, lists, tuples, NamedTuples;
    int leaves as 0-d arrays)."""
    if isinstance(state, dict):
        out = {}
        for k in sorted(state):
            out.update(flat_state(state[k], f"{prefix}/{k}"))
        return out
    if isinstance(state, (list, tuple)):
        names = getattr(state, "_fields", None) or range(len(state))
        out = {}
        for n, v in zip(names, state):
            out.update(flat_state(v, f"{prefix}/{n}"))
        return out
    if torch.is_tensor(state):
        return {prefix: state.detach().cpu().numpy()}
    return {prefix: np.asarray(state)}


def max_gap(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    return max((float(np.max(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))))
                if a[k].size else 0.0) for k in a)


def _entry(rank, world, init_file, task, payload_path, out_path, backend):
    import time

    import torch.distributed as dist

    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        end = time.time() + 600
        while not os.path.exists(payload_path):  # the parent sends it later
            if time.time() > end:
                raise TimeoutError("no payload")
            time.sleep(0.02)
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = TASKS[task](rank, world, payload)
        err = None
    except Exception:  # noqa: BLE001 — reported to the parent
        out, err = None, traceback.format_exc()
    try:
        if rank == 0 or err is not None:
            with open(f"{out_path}.{rank}", "wb") as f:
                pickle.dump({"out": out, "err": err}, f)
        if err is None:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world: int, task: str, tmp, backend: str = "gloo"):
    """Start the ranks, which import the port and wait for their payload.
    Returns (send, join): send(payload) hands it to them; join() waits for
    them and gives the first rank's result (raising with any rank's
    traceback)."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    payload_path = os.path.join(tmp, f"{task}.payload")
    out_path = os.path.join(tmp, f"{task}.out")
    ctx = mp.start_processes(_entry, args=(world, os.path.join(tmp, f"{task}.rdv"),
                                           task, payload_path, out_path, backend),
                             nprocs=world, start_method="spawn", join=False)

    def send(payload):
        with open(payload_path + ".tmp", "wb") as f:
            pickle.dump(payload, f)
        os.replace(payload_path + ".tmp", payload_path)

    def join(timeout: float = 600.0):
        import time

        end = time.time() + timeout
        while not ctx.join(timeout=max(end - time.time(), 1.0)):
            if time.time() > end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"mesh ranks of {task!r} did not finish")
        errs, result = [], None
        for r in range(world):
            path = f"{out_path}.{r}"
            if os.path.exists(path):
                with open(path, "rb") as f:
                    got = pickle.load(f)
                if got["err"]:
                    errs.append(f"rank {r}:\n{got['err']}")
                elif r == 0:
                    result = got["out"]
        if errs:
            raise RuntimeError("\n".join(errs))
        return result

    return send, join


# ---------------------------------------------------------------------------
# the rounds task: every cell of tests/test_torch_mesh_round.py
# ---------------------------------------------------------------------------


def _schedule(sched):
    from repro_torch.core.schedule import ClientSchedule

    return ClientSchedule(mask=np.asarray(sched[0], np.float32),
                          budget=np.asarray(sched[1], np.int32))


def _model(cfg_kw):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(cfg_kw["arch"], smoke=True).with_updates(**cfg_kw["updates"])
    return cfg, build_model(cfg)


def _hp(cell):
    from repro_torch.core.algorithms import HParams
    from repro_torch.core.lr_policy import server_scaled

    clr = server_scaled(cell["M"]) if cell.get("server_scaled") else None
    return HParams(lr=cell["lr"], local_steps=cell["local_steps"], component_lr=clr)


def _dense(cell):
    """The port's unsharded round: (losses, final state, eval)."""
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.train.loop import stage_batch

    cfg, model = _model(cell["cfg"])
    alg = get_algorithm(cell["alg"])
    hp = _hp(cell)
    rf = alg.round_fn(model, cell["M"], hp)
    state = copy.deepcopy(cell["init"])  # mtsl's round updates in place
    batch = stage_batch(cell["batch"], "cpu")
    losses = []
    for _ in range(cell["rounds"]):
        state, m = rf(state, batch, _schedule(cell["sched"]))
        losses.append(float(m["loss"]))
    ev = None
    if cfg.family in ("mlp", "resnet"):
        ev = {k: v.numpy() for k, v in alg.eval_fn(model, cell["M"])(state, batch).items()}
    return losses, flat_state(state), ev


def _sharded(cell, mesh, world, tally=None):
    """The sharded round on `mesh`: (losses, gathered state, eval, the
    largest gap between this rank's gathered state and every other
    rank's). `tally`, when given, gets the rounds' collective stats
    (`core.client_axis.collective_stats`)."""
    import torch.distributed as dist

    from repro_torch.core.algorithms import (
        gather_algorithm_state,
        get_algorithm,
        place_algorithm_state,
        shard_round_fn,
    )
    from repro_torch.core.client_axis import (client_axis, collective_stats,
                                              reset_collectives)
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.sharding import client_group

    cfg, model = _model(cell["cfg"])
    alg = get_algorithm(cell["alg"])
    hp = _hp(cell)
    chunk = cell.get("chunk")
    rf = shard_round_fn(alg, model, cell["M"], hp, mesh=mesh, client_chunk=chunk)
    state = place_algorithm_state(alg, cell["init"], mesh, client_chunk=chunk)
    batch = stage_batch(cell["batch"], "cpu")
    losses = []
    reset_collectives()
    for _ in range(cell["rounds"]):
        state, m = rf(state, batch, _schedule(cell["sched"]))
        losses.append(float(m["loss"]))
    if tally is not None:
        tally.update(collective_stats())
    ev = None
    if cfg.family in ("mlp", "resnet"):
        group = client_group(mesh)
        ev_fn = alg.eval_fn(model, cell["M"])
        with client_axis(chunk=chunk, group=group):
            rows = group.rows(cell["M"], chunk)
            ev = {k: v.numpy() for k, v in ev_fn(
                state, {k: v[rows] for k, v in batch.items()}).items()}
    whole = flat_state(gather_algorithm_state(alg, state, mesh, chunk))
    # every rank's whole state, flattened, against this rank's
    vec = torch.cat([torch.as_tensor(whole[k], dtype=torch.float64).reshape(-1)
                     for k in sorted(whole)])
    parts = [torch.empty_like(vec) for _ in range(world)]
    dist.all_gather(parts, vec)
    spread = max(float((p - vec).abs().max()) for p in parts)
    return losses, whole, ev, spread


def rounds_task(rank, world, payload):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_from_spec

    meshes = {spec: make_mesh_from_spec(spec) for spec in payload["meshes"]}
    out = {"cells": {}, "refusals": {}}
    try:
        make_mesh_from_spec(f"data={2 * world}")
    except ValueError as e:
        out["refusals"]["world"] = str(e)
    for key, cell in payload["cells"].items():
        res = {}
        if rank == 0 and cell.get("dense", True):
            res["dense"] = _dense(cell)
        res["collectives"] = {}
        res["mesh"] = _sharded(cell, meshes[cell["mesh"]], world, res["collectives"])
        out["cells"][key] = res
        dist.barrier()
    if "train" in payload:
        out["train"] = train_ckpt(payload["train"], meshes[payload["train"]["mesh"]])
    return out


def lm_train(p, mesh, rounds, *, init, start=0, path=None):
    """train() of p's LM cell (`p["cfg"]`, mtsl, sgd at p["lr"], p["M"]
    clients of p["b"] sequences of p["S"] tokens from the seeded LM
    source) from the whole state `init`, over client chunks of p["chunk"],
    on `mesh` or without one: the rounds after `start`, checkpointed to
    `path` after the last."""
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train

    cfg, model = _model(p["cfg"])
    src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=p["M"], beta=0.5,
                            seed=0)
    stream = list(client_batches(src, p["b"], steps=rounds, seed=0,
                                 seq_len=p["S"]))[start:]
    tcfg = TrainConfig(steps=rounds, algorithm="mtsl", lr=p["lr"], seed=0,
                       device="cpu", log_every=1, mesh=mesh, client_chunk=p["chunk"],
                       checkpoint_path=path)
    return train(model, sgd(p["lr"]), iter(stream), tcfg, p["M"], init_state=init,
                 start_round=start, log=lambda _: None)


def train_ckpt(p, mesh):
    """The chunked mesh run of tests/test_torch_moe_mesh_groups.py: p["cut"]
    rounds written to p["path"], then on to p["rounds"] from the gathered
    state: (losses and whole state at the cut, at the end)."""
    from repro_torch.core.algorithms import gather_algorithm_state, get_algorithm

    alg = get_algorithm("mtsl")
    out, init, start = {}, copy.deepcopy(p["init"]), 0
    for key, rounds, path in (("cut", p["cut"], p["path"]), ("end", p["rounds"], None)):
        state, hist = lm_train(p, mesh, rounds, init=init, start=start, path=path)
        init = gather_algorithm_state(alg, state, mesh, p["chunk"])
        out[key] = ([e["loss"] for e in hist], flat_state(init))
        start = rounds
    return out


# ---------------------------------------------------------------------------
# the checkpoint task: tests/test_torch_mesh_launch.py
# ---------------------------------------------------------------------------


def _setup(p):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model

    cfg = get_config("paper-mlp", smoke=True)
    src = MultiTaskImageSource(num_classes=cfg.num_classes, num_tasks=p["M"],
                               image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    return cfg, build_model(cfg), src


def run_train(p, mesh, rounds, *, path=None, init=None, start=0, source=None,
              alg="mtsl"):
    """train() as the tests drive it: sgd at p["lr"], server_scaled(M), a
    heterogeneous schedule, eval every 3 rounds; the rounds after `start`
    of the seeded synthetic stream (or `source`'s)."""
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import ScheduleConfig
    from repro_torch.data.pipeline import client_batches
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train

    cfg, model, src = _setup(p)
    M, b = p["M"], p["b"]
    stream = list(client_batches(source or src, b, steps=rounds, seed=0))[start:]
    evals = list(client_batches(src, b, steps=2, seed=5))
    tcfg = TrainConfig(steps=rounds, algorithm=alg, lr=p["lr"], seed=0,
                       device="cpu", log_every=1, eval_every=3, mesh=mesh,
                       checkpoint_path=path, batch_per_client=b,
                       schedule=ScheduleConfig(participation_rate=0.75, seed=3))
    return train(model, sgd(p["lr"]), iter(stream), tcfg, M,
                 component_lr=server_scaled(M), eval_batches=evals,
                 log=lambda _: None, init_state=init, start_round=start)


def ckpt_task(rank, world, p):
    from repro_torch.core.algorithms import gather_algorithm_state, get_algorithm
    from repro_torch.data import shards
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.train.checkpoint import load_algorithm_state
    from repro_torch.utils.sharding import client_group

    mesh = make_mesh_from_spec(f"data={world}")
    alg = get_algorithm("mtsl")
    cfg = _setup(p)[0]
    R, cut = p["rounds"], p["cut"]
    whole = lambda s: flat_state(gather_algorithm_state(alg, s, mesh))  # noqa: E731
    out = {}
    s_full, h_full = run_train(p, mesh, R, path=p["sharded_full"])
    out["full"] = (h_full, whole(s_full))
    _, h1 = run_train(p, mesh, cut, path=p["sharded_cut"])
    for key, path in (("resumed", p["sharded_cut"]), ("from_dense", p["dense_cut"])):
        init, _, extra = load_algorithm_state(path, "mtsl", cfg=cfg)
        s2, h2 = run_train(p, mesh, R, init=init, start=extra["round"])
        out[key] = (h1 + h2 if key == "resumed" else h2, whole(s2))
    # a cached dataset's per-rank block (built by the first rank)
    if rank == 0:
        shards.build_cache(p["cache"], _setup(p)[2], 32, seed=0)
    import torch.distributed as dist

    dist.barrier()
    g = client_group(mesh)
    ds = shards.load_cache(p["cache"]).subset(g.rows(p["M"]))
    s_c, h_c = run_train(p, mesh, R, source=ds)
    out["cached"] = (h_c, whole(s_c))
    return out


# ---------------------------------------------------------------------------
# the card task: tests/test_torch_mesh_cuda.py
# ---------------------------------------------------------------------------


def card_task(rank, world, p):
    """One mtsl round of paper-mlp on the card, unsharded (first rank) and
    on data=world: (dense loss, dense state, sharded loss, sharded state).
    Each rank's update must be one K1 launch."""
    from repro_torch.core.algorithms import (
        HParams,
        gather_algorithm_state,
        get_algorithm,
        place_algorithm_state,
        shard_round_fn,
    )
    from repro_torch.core.schedule import full_schedule
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.device import generator

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_from_spec(f"data={world}", device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, model = _model({"arch": "paper-mlp", "updates": {}})
    alg, M = get_algorithm("mtsl"), p["M"]
    hp = HParams(lr=p["lr"])
    init = alg.init_state(model, generator(dev, 0), M, hp)
    batch = stage_batch(p["batch"], dev)
    sched = full_schedule(M, 1)
    out = {}
    if rank == 0:
        s, m = alg.round_fn(model, M, hp)(copy.deepcopy(init), batch, sched)
        out["dense"] = (float(m["loss"]), flat_state(s))
    state = place_algorithm_state(alg, init, mesh, dev)
    n0 = mtsl_update_multi_.launches
    state, m = shard_round_fn(alg, model, M, hp, mesh=mesh)(state, batch, sched)
    launches = mtsl_update_multi_.launches - n0
    if launches != 1:
        raise AssertionError(f"rank {rank}: {launches} K1 launches, want 1")
    out["mesh"] = (float(m["loss"]), flat_state(gather_algorithm_state(alg, state, mesh)))
    return out


TASKS = {"rounds": rounds_task, "ckpt": ckpt_task, "card": card_task}
