"""How far f32 trajectories of the baselines part, on the CPU: the
measurements behind the tolerances that the baseline tests and
`chip_smoke.py`'s bparity phase hold (ROADMAP.md queue 3, "Facts").

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_baseline_drift.py \
        [name[:rounds] ...]

runs the named diagnostics (by default lm, mtsl, resnet and flips) and
prints, each from one initial state and the same numpy batches:

  lm      smoke zamba2-7b, splitfed, 2 local steps, masked schedule: the
          largest leaf gap of the port against the reference after each
          round at lr 0.1 and 0.05, and at lr 0.1 the gap of each f32 run
          to the port's run with f64 parameters;
  mtsl    smoke zamba2-7b, mtsl at lr 0.1: the gap after each of 8 rounds;
  resnet  full paper-resnet16, splitfed at lr 0.1, one local step a
          round, M = 10, b = 8: loss and gap after each of 8 rounds;
  flips   bparity's SMoFi (full paper-resnet16, seed 3, lr 0.01): after 2
          rounds, the ReLU inputs of round 3's first step whose sign in f32
          differs from f64, with the largest |f64 input| among them;
  collapse  chip_smoke.py's baselines setting (full paper-resnet16, M =
          10, b = 8, lr 0.1, 30 local steps a round, data seed 0, full
          rounds) for splitfed and smofi: the reference from its own init
          (PRNGKey(0)) and the port from that init, the loss of each
          after every round, and at the end whether each sits at 10·ln 10
          (every task's prediction uniform). `collapse:5` runs 5 rounds
          (default 15);
  nudge   the same setting for splitfed, 3 rounds: the reference from
          its init, the reference from that init with every leaf moved by
          one f32 ulp, and the port from the unmoved init; the loss of
          each after every round, to tell sensitivity from a port fault;
  overflow  the same setting for splitfed, 15 rounds: the reference and
          the port from the reference's init and from 8 inits with every
          leaf moved by +-1..+-4 f32 ulps (init i: 0 unmoved, 1..8 the
          moves +1, -1, +2, -2, ...); after each round whether the
          loss and every parameter of each package are finite. Prints
          the round at which each run first goes non-finite and, per
          package, how many of the runs did. `overflow:R:i-j` runs R
          rounds of inits i..j (default 15 rounds, inits 0-8).
"""
import itertools
import sys

import jax
import numpy as np
import torch
import torch.nn.functional as F

import torch_baseline_parity as P
from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import schedule
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import state_from_jax
from repro_torch.utils.device import generator
from repro_torch.utils.tree import tree_leaves, tree_map

P.SCHEDULES.setdefault("lm-masked", {"participation_rate": 0.5, "seed": 3})


def _gap(a, b):
    return max((float(np.abs(np.asarray(a[k], np.float64)
                             - np.asarray(b[k], np.float64)).max()), k) for k in b)


def _np(leaves):
    return {k: v.detach().numpy() if torch.is_tensor(v) else v
            for k, v in leaves.items()}


def lm():
    cfg = get_config("zamba2-7b", smoke=True)
    M = cfg.num_clients
    for lr in (0.1, 0.05):
        hp_j = P._hparams(jax_alg, "lm-masked", M, lr)
        _, _, state_j, rf_j, _ = P._reference("zamba2-7b", "splitfed", M, hp_j)
        hp = P._hparams(alg_mod, "lm-masked", M, lr)
        rf = alg_mod.get_algorithm("splitfed").round_fn(build_model(cfg), M, hp)
        rf64 = alg_mod.get_algorithm("splitfed").round_fn(
            build_model(cfg.with_updates(dtype="float64", param_dtype="float64")), M, hp)
        s32 = state_from_jax("splitfed", jax.tree.map(np.asarray, state_j), "cpu", cfg)
        s64 = tree_map(lambda x: x.double(), s32)
        stream_j, stream = P._streams("lm-masked", M, 2)
        _, stream64 = P._streams("lm-masked", M, 2)
        for r, batch in enumerate(P.batches(cfg, M, 2, 3)):
            state_j, _ = rf_j(state_j, batch, next(stream_j))
            s32, _ = rf(s32, stage_batch(batch, "cpu"), next(stream))
            s64, _ = rf64(s64, stage_batch(batch, "cpu"), next(stream64))
            ref, port = _np(P._leaves_ref(state_j)), _np(P._leaves_port(s32))
            line = f"lm lr {lr} round {r + 1}: port vs reference {_gap(port, ref)}"
            if lr == 0.1:
                f64 = _np(P._leaves_port(s64))
                line += (f"; reference vs f64 params {_gap(ref, f64)[0]:.3g}, "
                         f"port vs f64 params {_gap(port, f64)[0]:.3g}")
            print(line, flush=True)


def mtsl():
    cfg = get_config("zamba2-7b", smoke=True)
    M = cfg.num_clients
    model_j = jax_build_model(jax_get_config("zamba2-7b", smoke=True))
    hp_j, hp = jax_alg.HParams(lr=0.1), alg_mod.HParams(lr=0.1)
    alg_j = jax_alg.get_algorithm("mtsl")
    state_j = jax.jit(lambda k: alg_j.init_state(model_j, k, M, hp_j))(
        jax.random.PRNGKey(7))
    rf_j = jax_alg.jit_round_fn(alg_j, model_j, M, hp_j)
    rf = alg_mod.get_algorithm("mtsl").round_fn(build_model(cfg), M, hp)
    state = state_from_jax("mtsl", jax.tree.map(np.asarray, state_j), "cpu", cfg)
    kw = {"participation_rate": 0.5, "seed": 3}
    stream_j = jax_schedule.schedule_stream(jax_schedule.ScheduleConfig(**kw), M, 1, 2)
    stream = schedule.schedule_stream(schedule.ScheduleConfig(**kw), M, 1, 2)
    P.LOCAL_STEPS = 1
    try:
        batches = P.batches(cfg, M, 2, 8)
    finally:
        P.LOCAL_STEPS = 2
    for r, batch in enumerate(batches):
        state_j, _ = rf_j(state_j, batch, next(stream_j))
        state, _ = rf(state, stage_batch(batch, "cpu"), next(stream))
        print(f"mtsl round {r + 1}: port vs reference "
              f"{_gap(_np(P._leaves_port(state.params)), P._leaves_ref(state_j.params))}",
              flush=True)


def resnet():
    cfg = get_config("paper-resnet16")
    M = cfg.num_clients
    model_j = jax_build_model(jax_get_config("paper-resnet16"))
    hp_j, hp = (jax_alg.HParams(lr=0.1, local_steps=1),
                alg_mod.HParams(lr=0.1, local_steps=1))
    alg_j = jax_alg.get_algorithm("splitfed")
    state_j = jax.jit(lambda k: alg_j.init_state(model_j, k, M, hp_j))(
        jax.random.PRNGKey(0))
    rf_j = jax_alg.jit_round_fn(alg_j, model_j, M, hp_j)
    rf = alg_mod.get_algorithm("splitfed").round_fn(build_model(cfg), M, hp)
    state = state_from_jax("splitfed", jax.tree.map(np.asarray, state_j), "cpu", cfg)
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    for r, batch in enumerate(client_batches(src, 8, steps=8, seed=0)):
        state_j, met_j = rf_j(state_j, batch, jax_schedule.full_schedule(M, 1))
        state, met = rf(state, stage_batch(batch, "cpu"), schedule.full_schedule(M, 1))
        print(f"resnet round {r + 1}: loss {float(met_j['loss']):.4f} / "
              f"{float(met['loss']):.4f}, port vs reference "
              f"{_gap(_np(P._leaves_port(state)), P._leaves_ref(state_j))}", flush=True)


class _Relus(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.relu:
            self.seen.append(args[0])
        return func(*args, **(kwargs or {}))


def flips():
    cfg = get_config("paper-resnet16")
    M, b, ls = cfg.num_clients, 8, 2
    scfg = schedule.ScheduleConfig(participation_rate=0.5, straggler_frac=0.5, seed=3)
    hp = alg_mod.HParams(lr=0.01, local_steps=ls,
                         capability=tuple(schedule.capability_profile(M, scfg)))
    model = build_model(cfg)
    alg = alg_mod.get_algorithm("smofi")
    state = alg.init_state(model, generator("cpu", 3), M, hp)
    rf = alg.round_fn(model, M, hp)
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=3)
    batches = list(client_batches(src, b * ls, steps=3, seed=3))
    scheds = list(itertools.islice(schedule.schedule_stream(scfg, M, ls), 3))
    for batch, sched in zip(batches[:2], scheds[:2]):
        state, _ = rf(state, stage_batch(batch, "cpu"), sched)
    x = stage_batch(batches[2], "cpu")["image"][:, :b]

    def relu_inputs(dt):
        towers = tree_map(lambda t: t.to(dt), state["towers"])
        server = tree_map(lambda t: t.to(dt), state["server"])

        def fwd(tp, img):
            mode = _Relus()
            mode.seen = []
            with mode:
                model.server_forward(server, model.tower_forward(tp, {"image": img}))
            return mode.seen

        return [a.double() for a in torch.func.vmap(fwd)(towers, x.to(dt))]

    for i, (a, t) in enumerate(zip(relu_inputs(torch.float32),
                                   relu_inputs(torch.float64))):
        f = (a > 0) != (t > 0)
        if f.any():
            print(f"flips relu{i} {tuple(a.shape)}: {int(f.sum())} inputs, largest "
                  f"|f64 input| {float(t[f].abs().max()):.3g}", flush=True)


def collapse(rounds=15):
    cfg = get_config("paper-resnet16")
    M, b, ls = cfg.num_clients, 8, 30
    model_j = jax_build_model(jax_get_config("paper-resnet16"))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    batches = list(client_batches(src, b * ls, steps=int(rounds), seed=0))
    uniform = M * np.log(cfg.num_classes)
    for name in ("splitfed", "smofi"):
        hp_j = jax_alg.HParams(lr=0.1, local_steps=ls)
        alg_j = jax_alg.get_algorithm(name)
        state_j = jax.jit(lambda k: alg_j.init_state(model_j, k, M, hp_j))(
            jax.random.PRNGKey(0))
        rf_j = jax_alg.jit_round_fn(alg_j, model_j, M, hp_j)
        rf = alg_mod.get_algorithm(name).round_fn(
            build_model(cfg), M, alg_mod.HParams(lr=0.1, local_steps=ls))
        state = state_from_jax(name, jax.tree.map(np.asarray, state_j), "cpu", cfg)
        for r, batch in enumerate(batches):
            state_j, met_j = rf_j(state_j, batch, jax_schedule.full_schedule(M, ls))
            state, met = rf(state, stage_batch(batch, "cpu"), schedule.full_schedule(M, ls))
            print(f"collapse {name} round {r + 1}: loss reference "
                  f"{float(met_j['loss']):.4f}, port {float(met['loss']):.4f}", flush=True)
        print(f"collapse {name}: 10·ln 10 = {uniform:.4f}; reference ends "
              f"{abs(float(met_j['loss']) - uniform) < 1e-3}, port ends "
              f"{abs(float(met['loss']) - uniform) < 1e-3}", flush=True)


def nudge(rounds=3):
    cfg = get_config("paper-resnet16")
    M, b, ls = cfg.num_clients, 8, 30
    model_j = jax_build_model(jax_get_config("paper-resnet16"))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    batches = list(client_batches(src, b * ls, steps=int(rounds), seed=0))
    hp_j = jax_alg.HParams(lr=0.1, local_steps=ls)
    alg_j = jax_alg.get_algorithm("splitfed")
    state_j = jax.jit(lambda k: alg_j.init_state(model_j, k, M, hp_j))(
        jax.random.PRNGKey(0))
    moved_j = jax.tree.map(lambda x: np.nextafter(np.asarray(x), np.float32(np.inf)),
                           state_j)
    rf_j = jax_alg.jit_round_fn(alg_j, model_j, M, hp_j)
    rf = alg_mod.get_algorithm("splitfed").round_fn(
        build_model(cfg), M, alg_mod.HParams(lr=0.1, local_steps=ls))
    state = state_from_jax("splitfed", jax.tree.map(np.asarray, state_j), "cpu", cfg)
    for r, batch in enumerate(batches):
        state_j, met_j = rf_j(state_j, batch, jax_schedule.full_schedule(M, ls))
        moved_j, met_m = rf_j(moved_j, batch, jax_schedule.full_schedule(M, ls))
        state, met = rf(state, stage_batch(batch, "cpu"), schedule.full_schedule(M, ls))
        print(f"nudge splitfed round {r + 1}: loss reference "
              f"{float(met_j['loss']):.4f}, reference moved one ulp "
              f"{float(met_m['loss']):.4f}, port {float(met['loss']):.4f}", flush=True)


_MOVES = (0, 1, -1, 2, -2, 3, -3, 4, -4)


def _moved(x, k):
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        return x
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf))
    return x


def _finite(leaves):
    return all(bool(np.isfinite(np.asarray(x, np.float64)).all()) for x in leaves)


def overflow(rounds=15, inits="0-8"):
    cfg = get_config("paper-resnet16")
    M, b, ls = cfg.num_clients, 8, 30
    lo, hi = (int(v) for v in str(inits).split("-"))
    model_j = jax_build_model(jax_get_config("paper-resnet16"))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    batches = list(client_batches(src, b * ls, steps=int(rounds), seed=0))
    hp_j = jax_alg.HParams(lr=0.1, local_steps=ls)
    alg_j = jax_alg.get_algorithm("splitfed")
    init_j = jax.tree.map(np.asarray, jax.jit(
        lambda k: alg_j.init_state(model_j, k, M, hp_j))(jax.random.PRNGKey(0)))
    rf_j = jax_alg.jit_round_fn(alg_j, model_j, M, hp_j)
    rf = alg_mod.get_algorithm("splitfed").round_fn(
        build_model(cfg), M, alg_mod.HParams(lr=0.1, local_steps=ls))
    runs = []
    for i in range(lo, hi + 1):
        state_j = jax.tree.map(lambda x, k=_MOVES[i]: _moved(x, k), init_j)
        runs.append({"i": i, "ref": state_j, "port": state_from_jax(
            "splitfed", state_j, "cpu", cfg), "bad": {"reference": None, "port": None}})
    # breadth first: every init advances one round before any takes the
    # next, so a run cut short still covers all inits equally
    for r, batch in enumerate(batches):
        for run in runs:
            run["ref"], met_j = rf_j(run["ref"], batch, jax_schedule.full_schedule(M, ls))
            run["port"], met = rf(run["port"], stage_batch(batch, "cpu"),
                                  schedule.full_schedule(M, ls))
            ok_j = _finite([met_j["loss"]] + jax.tree.leaves(run["ref"]))
            ok = _finite([met["loss"].detach()]
                         + [x.detach() for x in tree_leaves(run["port"])])
            for name, fine in (("reference", ok_j), ("port", ok)):
                if not fine and run["bad"][name] is None:
                    run["bad"][name] = r + 1
            print(f"overflow init {run['i']} (move {_MOVES[run['i']]:+d} ulp) round "
                  f"{r + 1}: loss reference {float(met_j['loss']):.4f} finite {ok_j}, "
                  f"port {float(met['loss']):.4f} finite {ok}", flush=True)
    for name in ("reference", "port"):
        rs = [run["bad"][name] for run in runs]
        print(f"overflow {name}: {sum(r is not None for r in rs)} of {len(rs)} "
              f"runs non-finite within {rounds} rounds (first non-finite round "
              f"per init {rs})", flush=True)


if __name__ == "__main__":
    for name, *args in [a.split(":") for a in sys.argv[1:]] or [
            ["lm"], ["mtsl"], ["resnet"], ["flips"]]:
        globals()[name](*args)
