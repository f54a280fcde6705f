"""The training driver (traffic kind "mtsl_train"): mtsl rounds of the
program's loop (`repro_torch.train.loop.train`, prefetch as the traffic
says, the full synchronous schedule, SGD at lr with `server_scaled(M)`
component rates), timed from the outside.

Set-up makes the weights on the card from the seed (`lib/weights.py`)
into the program's own TrainState, draws the traffic, and drives that
state through its first `compared_steps` rounds with the window's own
call and feed; their losses, the first gradient of each leaf (from the
change SGD made: (w_0 - w_1) / eta) and each leaf's change after the
last of them are what the reference is held to. The window then runs
whole rounds until about `--seconds` have passed (the round count is
fixed from the set-up's round time), on the same state and stream.

With `--trace 1` the window is split: timed rounds, a profiled stretch
of about `profiled_s` (`lib/trace.py`), timed rounds; the whole-step
MFU reads the timed rounds only.

After the window the program's state is freed and the reference
(`perfbench/reference/train.py`) runs the same first rounds from the same
weights and batches.
"""
from __future__ import annotations

import gc
import itertools
import math
import statistics
import time
from types import SimpleNamespace
from typing import Dict

import torch

from perfbench.lib import bench, trace as tracing, weights
from perfbench.lib.lm_data import MultiTaskLMSource, client_batches
from perfbench.reference import train as reference


def _program(w: dict, device):
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.mtsl import TrainState, init_state
    from repro_torch.models.registry import build_model
    from repro_torch.nn.init import abstract_params
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.utils.tree import tree_map

    t = w["traffic_spec"]
    M, lr = t["num_clients"], t["lr"]
    model = build_model(bench.model_config(w["cfg"]))
    with abstract_params():
        meta = init_state(model, torch.Generator(), M)
    params = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
                      .requires_grad_(), meta)
    state = TrainState(params, sgd(lr).init(params), 0)

    def rounds(state, batches, start: int, n: int, log_every: int = 0):
        tcfg = TrainConfig(steps=start + n, lr=lr, log_every=log_every, seed=0,
                           device=device.type, prefetch=t["prefetch"])
        return train(model, sgd(lr), batches, tcfg, M, component_lr=server_scaled(M),
                     log=lambda _: None, init_state=state, start_round=start)

    return state, rounds


def _norms(leaves: Dict[str, torch.Tensor], spec, seed, device):
    """{leaf: ||w - w_0||} of the program's leaves, w_0 drawn again."""
    out = {n: (leaves[n].detach().float() - p0).norm()
           for n, p0 in weights.initial_leaves(spec, seed, device)}
    names = sorted(out)
    return dict(zip(names, torch.stack([out[n] for n in names]).tolist()))


def compare(prog: dict, ref: dict, lr: float, M: int) -> Dict[str, dict]:
    """The numbers the limits may hold (a cell's limits file names those it
    holds): the worst step's loss gap; for the first gradient's norm and
    the change's norm, the worst leaf's gap and the median leaf's gap, each
    leaf's against the reference's norm of that leaf or of the median
    leaf, whichever is larger; and, to read where the gaps come from, the
    worst gap of each kind of leaf (its last name). Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out (none
    is moved by more than round-off)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    names = sorted(ref["grad"])
    g_ref = ref["grad"]
    med_g = statistics.median(g_ref.values())
    moved = [n for n in names if g_ref[n] >= 1e-3 * med_g]
    g_prog = {n: prog["first_change"][n] / reference.eta(n, lr, M) for n in moved}
    med_d = statistics.median(ref["change"][n] for n in moved)
    out = {"loss_gap": {"value": loss},
           "loss1_gap": {"value": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])},
           "_left_out": len(names) - len(moved)}
    for key, got, want, med in (("grad", g_prog, g_ref, med_g),
                                ("change", prog["change"], ref["change"], med_d)):
        gaps = {n: abs(got[n] - want[n]) / max(want[n], med) for n in moved}
        worst = max(gaps, key=gaps.get)
        out[f"{key}_gap"] = {"value": gaps[worst], "leaf": worst}
        out[f"{key}_median_gap"] = {"value": statistics.median(gaps.values())}
        kinds: Dict[str, float] = {}
        for n, v in gaps.items():
            kind = n.rsplit("/", 1)[-1]
            kinds[kind] = max(kinds.get(kind, 0.0), v)
        out[f"_{key}_by_kind"] = kinds
    return out


def prepare(w: dict, seed: int, device) -> SimpleNamespace:
    """Set-up: the program's state made from the seed, the traffic, and the
    compared rounds through the window's own call and feed."""
    t = w["traffic_spec"]
    M, b, S = t["num_clients"], t["batch_per_client"], t["seq_len"]
    steps = t["compared_steps"]
    spec = weights.specs(w["cfg"], M)
    state, rounds = _program(w, device)
    leaves = weights.port_leaves(state.params)
    weights.check_same(spec, leaves)
    with torch.no_grad():
        weights.fill_(leaves, spec, seed)
    src = MultiTaskLMSource(t["data_vocab"], M, t["beta"], seed)
    stream = client_batches(src, b, S, seed)
    first = list(itertools.islice(stream, steps))
    losses = []
    state, hist = rounds(state, iter(first[:1]), 0, 1, 1)
    losses += [h["loss"] for h in hist]
    first_change = _norms(leaves, spec, seed, device)
    _sync(device)
    t0 = time.perf_counter()
    state, hist = rounds(state, iter(first[1:]), 1, steps - 1, 1)
    losses += [h["loss"] for h in hist]
    _sync(device)
    per_round = (time.perf_counter() - t0) / (steps - 1)
    prog = {"loss": losses, "first_change": first_change,
            "change": _norms(leaves, spec, seed, device)}
    return SimpleNamespace(state=state, rounds=rounds, stream=stream, first=first,
                           spec=spec, prog=prog, per_round=per_round, done=steps)


def check(w: dict, seed: int, prog: dict, first: list, spec, device) -> tuple:
    """(the numbers compared, the reference's readings) of the program's
    compared rounds against the reference's."""
    t = w["traffic_spec"]
    ref = reference.rounds(w["cfg"], spec, seed, first, t["lr"], t["num_clients"], device)
    return compare(prog, ref, t["lr"], t["num_clients"]), ref


def as_program(ref: dict, lr: float, M: int) -> dict:
    """A reference run's readings in the program's form (the control, or a
    planted fault, put in the program's place)."""
    return {"loss": ref["loss"], "change": ref["change"],
            "first_change": {n: g * reference.eta(n, lr, M) for n, g in ref["grad"].items()}}


def run(w: dict, seed: int, seconds: float, trace: bool, device, started) -> dict:
    t = w["traffic_spec"]
    M, b, S = t["num_clients"], t["batch_per_client"], t["seq_len"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    p = prepare(w, seed, device)
    state, rounds, stream, per_round, done = p.state, p.rounds, p.stream, p.per_round, p.done
    p.state = p.rounds = None
    n = max(2, round(seconds / per_round))
    setup_s = started()

    # the window
    timed_rounds, timed_s, tr, k = 0, 0.0, None, 0
    parts = [n] if not trace else [math.ceil(n / 2), None, n - math.ceil(n / 2)]
    for part in parts:
        if part is None:
            k = max(1, round(t["profiled_s"] / per_round))

            def stretch(state=state, k=k, done=done):
                return rounds(state, itertools.islice(stream, k), done, k)

            tr, (state, hist) = tracing.stretch(torch, stretch)
            del stretch
            done += k
            continue
        if part == 0:
            continue
        _sync(device)
        t0 = time.perf_counter()
        state, hist = rounds(state, itertools.islice(stream, part), done, part)
        _sync(device)
        timed_s += time.perf_counter() - t0
        timed_rounds += part
        done += part
    last_loss = hist[-1]["loss"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not trace:
        metrics = {"train_tokens_s": {"value": timed_rounds * M * b * S / timed_s,
                                      "unit": "tokens/s"},
                   "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        ctx = SimpleNamespace(cfg=w["cfg"], traffic=t, trace=tr, stretch_rounds=k,
                              timed_rounds=timed_rounds, timed_s=timed_s)
        metrics = bench.per_layer(w, ctx)

    # the reference, once the program's state is gone
    del state, hist, rounds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, _ = check(w, seed, p.prog, p.first, p.spec, device)
    return {"metrics": metrics, "numbers": numbers, "attempted": done,
            "failed": 0 if math.isfinite(last_loss) else 1, "peak": peak, "trace": tr}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
