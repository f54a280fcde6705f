"""The federated baselines and FedEM (port of `repro.core.federation`).

The paper's comparison is an ablation of where the federation all-reduce
goes:

    mtsl:     towers private (no collective), server grads summed.
    splitfed: tower grads averaged over clients (the split-part federation),
              server as mtsl.
    fedavg:   everything averaged over clients (classic federation).

`sync_transform` is that gradient transformation. The round builders run
the baselines as the compared papers do, with LOCAL steps between
federation rounds:

  fedprox / fedavg  per-client full models, proximal local SGD (mu = 0 is
                    FedAvg), then the participation mean [Li et al., 2020].
  splitfed          split steps against the central server, then the
                    towers fed-average [Thapa et al.].
  parallelsfl       clusters of clients, each against its own server
                    replica; towers average within a cluster, replicas
                    merge globally [Liao et al., 2024].
  smofi             splitfed whose per-client server replicas fuse their
                    momentum every step, stored once [Yang et al., 2025].
  fedem             a mixture of K full models with per-client
                    responsibilities [Marfoq et al., 2021].

Every builder's fn takes `(state, batch, schedule=None)`: `batch` holds
`[M, local_steps, b, ...]` tensors on the state's device and `schedule` is
a numpy `core.schedule.ClientSchedule` (None: all clients, full budget).
Federation means run over participants only, a straggler stops stepping
once its budget is spent, and FedEM freezes non-participants'
responsibilities.

How the port maps the reference's transforms:

  * clients: `_client_value_and_grad` maps the per-client loss over a
    leading axis of N parameter copies (N = M clients, or M·K for FedEM),
    with one backward pass for all of them (the clients' parameters are
    disjoint, so the gradient of the summed losses is each client's own).
    The classifiers map with `torch.func.vmap`; the LMs loop over the
    copies in Python (`unbind` views), because their kernels are ctypes
    calls that vmap cannot trace. The reference's `jax.vmap` of
    `value_and_grad` computes the same function.
  * local steps: a Python loop in place of `lax.scan`.
  * the plain SGD step `p - lr·g` of every leaf a local step updates goes
    through K1 (`mtsl_update_multi_`), one launch per local step, with one
    step size per row: `lr·active` on per-client rows, so a straggler past
    its budget (or an inactive cluster, or a step with no active client)
    holds its parameters bit for bit (η = 0, the reference's
    `jnp.where(active, new, old)` and `g·a` for a finite g). K1 rounds
    η·g before the subtraction, as the reference does. The proximal term,
    SMoFi's momentum buffer, the federation means and FedEM's
    responsibilities stay plain tensor code.
  * each round works on copies of the state's parameters (the local phase
    returns them), so a phase never changes the state it was given.
  * client chunking (core/client_axis.py): `_client_value_and_grad` is the
    seam the reference's `_vmap_with_smask` is. Under `client_axis(chunk=
    c)` it runs the copies in blocks of c clients, each block's forward
    and backward before the next, so one block's activations are live at
    a time (the copies' parameters are disjoint, so every block's
    gradients are its own). The evals map through `client_map`; splitfed's
    local step goes through mtsl's chunked loss.
  * the client axis over a mesh (core/client_axis.py): a rank runs the
    rounds on its block of M/D clients (every round function takes the client
    count from the tensors it is given) and each cross-client reduction is
    a local reduction followed by an all-reduce over the client group:
      - fedavg / fedprox: the round-end full-model means and their weight
        totals (`participation_tree_mean`; under sample weighting also the
        largest weight, a max);
      - splitfed: the central server's gradient every local step (mtsl's
        `_sum_server`) and the round-end tower mean;
      - smofi: the active clients' mean server gradient fused into the
        momentum every local step, whether any client is active, and the
        round-end tower mean;
      - parallelsfl: each cluster's weighted sums and weight totals, every
        local step for the replicas' gradients and at round end for the
        towers (a cluster's members may sit on several ranks, so
        `_cluster_wmean` always reduces); the replicas' merge is over the
        replicated [C] axis and stays local;
      - fedem: the round-end component means over the participants;
      - `sync_transform`'s tower mean;
      - every round's per-task loss and every eval's per-task accuracy,
        gathered before their sum or mean.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.client_axis import (
    client_blocks,
    client_map,
    client_sum,
    client_sum_,
    current_chunk,
    current_group,
    gather_clients,
)
from repro_torch.core.mtsl import (
    _at_least_f32,
    _ce_logits,
    _chunked_grads,
    _lm_loss,
    _sum_server,
    make_loss_fn,
)
from repro_torch.core.phases import PhaseProgram, compose_phases
from repro_torch.core.schedule import (
    ClientSchedule,
    broadcast_weights,
    full_schedule,
    participation_bcast_mean,
    participation_tree_mean,
    schedule_sample_mask,
    schedule_tensors,
    step_activity,
)
from repro_torch.core.split import replicate_tower, stack_towers
from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
from repro_torch.models.registry import Model
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

PyTree = Any

ALGORITHMS = ("mtsl", "splitfed", "fedavg")


def sync_transform(algorithm: str, num_clients: int) -> Callable[[PyTree], PyTree]:
    """The gradient transformation of `algorithm`'s single-step form:
    identity (mtsl), tower mean (splitfed), tower mean and server / M
    (fedavg)."""
    if algorithm == "mtsl":
        return lambda grads: grads

    def _mean(g):
        if current_group() is None:
            return g.mean(0, keepdim=True)
        return client_sum(g.sum(0, keepdim=True)) / num_clients

    def _avg_towers(grads):
        towers = tree_map(lambda g: _mean(g).expand(g.shape), grads["towers"])
        return {**grads, "towers": towers}

    if algorithm == "splitfed":
        return _avg_towers

    if algorithm == "fedavg":
        inv = 1.0 / num_clients

        def _fedavg(grads):
            grads = _avg_towers(grads)
            return {**grads, "server": tree_map(lambda g: g * inv, grads["server"])}

        return _fedavg

    raise ValueError(f"unknown algorithm {algorithm!r}; have {ALGORITHMS} + fedem")


# ---------------------------------------------------------------------------
# per-client full-model loss and its gradient over a client axis
# ---------------------------------------------------------------------------


def _is_classifier(model: Model) -> bool:
    return model.cfg.family in ("mlp", "resnet")


def full_model_loss(model: Model) -> Callable:
    """loss_fn(params_c, mb, smask=None) -> scalar: one client's full model
    (tower then server, no client axis) on one local batch; mtsl's per-task
    loss of one task (the classifiers' mean cross-entropy, the LMs' mean
    next-token cross-entropy) plus the server's aux loss.

    `smask` (optional [b] {0,1}) selects the live samples of a padded
    local batch (capability batch sizing): the mean runs over live samples
    only."""
    classifier = _is_classifier(model)

    def loss_fn(params_c, mb, smask=None):
        inputs = {k: v for k, v in mb.items() if k != "label"}
        smashed = model.tower_forward(params_c["tower"], inputs)
        logits, aux = model.server_forward(params_c["server"], smashed)
        logits = _at_least_f32(logits)[None]  # one task
        sm = None if smask is None else smask[None]
        if classifier:
            return _ce_logits(logits, mb["label"][None], sm)[0] + aux
        return _lm_loss(logits, mb["tokens"][None], sm)[0] + aux

    return loss_fn


def _client_value_and_grad(model: Model) -> Callable:
    """vg(params, batch, smask=None, objective=None, group=1) -> (losses
    [N], grads): `full_model_loss` over the leading axis N of `params`
    (each leaf [N, ...]), `batch` ([N, b, ...]) and `smask` ([N, b]);
    grads of `objective(losses)` (default: their sum, i.e. each copy's own
    gradient) with `params`' structure. The classifiers map with vmap, the
    LMs loop over unbind views (see the module docstring). Under a client
    chunk the copies run in blocks of chunk·group rows (`group`: rows per
    client, K for FedEM), each block's backward before the next block's
    forward; `objective` is then applied to each block's losses, so it
    must be separable over whole clients."""
    loss_fn = full_model_loss(model)
    classifier = _is_classifier(model)

    def block(params, leaves, batch, smask, objective):
        p = tree_unflatten_like(params, leaves)
        if classifier:
            if smask is None:
                losses = torch.func.vmap(lambda q, b: loss_fn(q, b))(p, batch)
            else:
                losses = torch.func.vmap(loss_fn)(p, batch, smask)
        else:
            views = zip(*(x.unbind(0) for x in leaves))
            losses = torch.stack([
                loss_fn(tree_unflatten_like(params, v),
                        {k: x[n] for k, x in batch.items()},
                        None if smask is None else smask[n])
                for n, v in enumerate(views)])
        total = losses.sum() if objective is None else objective(losses)
        return losses.detach(), torch.autograd.grad(total, leaves)

    def vg(params, batch, smask=None, objective=None, group=1):
        full = tree_leaves(params)
        losses, grads = [], []
        for sl in client_blocks(full[0].shape[0], group=group):
            leaves = [x[sl].detach().requires_grad_() for x in full]
            l, g = block(params, leaves, {k: x[sl] for k, x in batch.items()},
                         None if smask is None else smask[sl], objective)
            losses.append(l)
            grads.append(g)
        if len(grads) == 1:
            return losses[0], tree_unflatten_like(params, grads[0])
        return torch.cat(losses), tree_unflatten_like(
            params, [torch.cat(g) for g in zip(*grads)])

    return vg


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _copy(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def _in_budget(budget, local_steps: int):
    """[k, M] f32: local step t is within client m's budget (the
    stragglers' hold; participation is not part of it)."""
    return step_activity(torch.ones(budget.shape, device=budget.device),
                         budget, local_steps)


def _step_batch(batch, t: int):
    """Local step t of a [M, local_steps, b, ...] round batch."""
    return {k: v[:, t].contiguous() for k, v in batch.items()}


def _sgd_step(ps, gs, etas) -> None:
    """p <- p - eta·g for every leaf, through K1 in one launch."""
    mtsl_update_multi_(ps, [g.reshape(p.shape) for p, g in zip(ps, gs)], etas)


def _round_metrics(per_last) -> dict:
    """{"loss", "per_task"} of a round from the per-task losses of this
    process's clients (gathered over the client group under a mesh)."""
    per = gather_clients(per_last)
    return {"loss": per.sum(), "per_task": per}


# ---------------------------------------------------------------------------
# fedprox / fedavg: local full-model steps, then full-model averaging
# ---------------------------------------------------------------------------


def build_fedprox_round(model: Model, lr: float, num_clients: int,
                        local_steps: int, mu: float = 0.0,
                        sample_weighted: bool = False) -> Callable:
    """One FedProx ROUND [Li et al., 2020]: every client runs `local_steps`
    SGD steps on its own data, each minimising loss(p) + (mu/2)·||p -
    p_round_start||², then the full models are averaged over the
    participants (weighted by transmitted samples under
    `sample_weighted` and capability batching) and given back to every
    client. mu = 0 is FedAvg. params: {"towers": [M, ...], "servers":
    [M, ...]}."""
    return compose_phases(
        build_fedprox_phases(model, lr, num_clients, local_steps, mu=mu,
                             sample_weighted=sample_weighted),
        lambda: full_schedule(num_clients, local_steps))


def build_fedprox_phases(model: Model, lr: float, num_clients: int,
                         local_steps: int, mu: float = 0.0,
                         sample_weighted: bool = False) -> PhaseProgram:
    """FedProx as a phase program: `local` runs every client's proximal
    local steps and returns {"pcs": per-client params, "losses": [M]};
    `apply` is the round-end federation mean over the participants."""
    vg = _client_value_and_grad(model)

    def local_phase(params, batch, schedule: ClientSchedule):
        _, budget, _ = schedule_tensors(schedule, _device(params))
        smask = schedule_sample_mask(schedule, batch)
        active = _in_budget(budget, local_steps)  # [k, M]
        eta = lr * active
        anchor = {"tower": params["towers"], "server": params["servers"]}
        pcs = _copy(anchor)
        ps, anchors = tree_leaves(pcs), tree_leaves(anchor)
        losses = []
        for t in range(local_steps):
            loss, grads = vg(pcs, _step_batch(batch, t), smask)
            gs = tree_leaves(grads)
            if mu:
                gs = [g + mu * (p - a) for g, p, a in zip(gs, ps, anchors)]
            _sgd_step(ps, gs, [eta[t]] * len(ps))
            losses.append(loss)
        # per-client loss over the steps it actually ran
        per = ((torch.stack(losses) * active).sum(0)
               / torch.clamp(active.sum(0), min=1.0))
        return {"pcs": pcs, "losses": per}

    def apply_phase(params, payload, schedule: ClientSchedule):
        mask, _, sizes = schedule_tensors(schedule, _device(params))
        fed_w = sizes.float() if sample_weighted and sizes is not None else None
        avg = participation_tree_mean(payload["pcs"], mask, fed_w, bcast=True)
        new = {"towers": avg["tower"], "servers": avg["server"]}
        return new, _round_metrics(payload["losses"] * mask)

    return PhaseProgram(local_phase, apply_phase)


def build_fedavg_round(model: Model, lr: float, num_clients: int,
                       local_steps: int, sample_weighted: bool = False) -> Callable:
    """One FedAvg ROUND: FedProx with mu = 0."""
    return build_fedprox_round(model, lr, num_clients, local_steps, mu=0.0,
                               sample_weighted=sample_weighted)


def init_fedavg_params(model: Model, gen: torch.Generator, num_clients: int):
    """One full model, copied to every client."""
    return {"towers": replicate_tower(model.init_tower, gen, num_clients),
            "servers": replicate_tower(model.init_server, gen, num_clients)}


def _client_accuracy(model: Model):
    """acc(tp, sp, inputs, labels) -> one client's accuracy (mapped with
    vmap over the client axis)."""

    def acc(tp, sp, inputs, labels):
        logits, _ = model.server_forward(sp, model.tower_forward(tp, inputs))
        preds = logits.float().argmax(-1)
        return (preds == labels).float().mean()

    return acc


def eval_fedavg(model: Model, num_clients: int):
    """Eval per task with client m's copy of the (shared) model."""
    acc = _client_accuracy(model)

    @torch.no_grad()
    def eval_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "label"}
        accs = gather_clients(client_map(acc, params["towers"], params["servers"],
                                         inputs, batch["label"]))
        return {"per_task_acc": accs, "acc_mtl": accs.mean()}

    return eval_fn


# ---------------------------------------------------------------------------
# splitfed: local split steps against the central server, then tower FedAvg
# ---------------------------------------------------------------------------


def build_splitfed_round(model: Model, lr: float, num_clients: int,
                         local_steps: int) -> Callable:
    """One SplitFed ROUND [Thapa et al.]: `local_steps` split-learning steps
    against the CENTRAL server (it steps every step, as in mtsl), then the
    towers fed-average over the participants. An inactive client (not
    sampled, or past its budget) gives the server no gradient and its
    tower holds. params: {"towers": [M, ...], "server": ...}."""
    return compose_phases(
        build_splitfed_phases(model, lr, num_clients, local_steps),
        lambda: full_schedule(num_clients, local_steps))


def build_splitfed_phases(model: Model, lr: float, num_clients: int,
                          local_steps: int) -> PhaseProgram:
    """SplitFed as a phase program: `local` is the per-step split loop
    (the cohort trains jointly against the central server, which is part
    of the payload); `apply` federates the towers over the participants
    and commits the server."""
    loss_fn = make_loss_fn(model, num_clients)

    def local_phase(params, batch, schedule: ClientSchedule):
        dev = _device(params)
        mask, budget, _ = schedule_tensors(schedule, dev)
        act = step_activity(mask, budget, local_steps)  # [k, M]
        smask = schedule_sample_mask(schedule, batch)
        p = _copy(params)
        ps = tree_leaves(p)
        eta = torch.full((1,), lr, dtype=torch.float32, device=dev)
        per = []
        chunk = current_chunk()
        for t in range(local_steps):
            if chunk is not None and chunk < mask.shape[0]:
                metrics, grads = _chunked_grads(model, chunk, p,
                                                _step_batch(batch, t), act[t], smask)
            else:
                req = [x.detach().requires_grad_() for x in ps]
                obj, metrics = loss_fn(tree_unflatten_like(p, req),
                                       _step_batch(batch, t), act[t], smask)
                grads = _sum_server(tree_unflatten_like(
                    p, torch.autograd.grad(obj, req)))
            gs = [g for k in p for g in tree_leaves(grads[k])]
            _sgd_step(ps, gs, [eta] * len(ps))
            per.append(metrics["per_task"].detach())
        return {"params": p, "per": torch.stack(per)}

    def apply_phase(params, payload, schedule: ClientSchedule):
        mask, _, _ = schedule_tensors(schedule, _device(params))
        p, per = payload["params"], payload["per"]
        towers = participation_tree_mean(p["towers"], mask, bcast=True)
        return ({"towers": towers, "server": p["server"]},
                _round_metrics(per[-1] * mask))

    return PhaseProgram(local_phase, apply_phase)


# ---------------------------------------------------------------------------
# parallelsfl: cluster-wise split federation with per-cluster server replicas
# ---------------------------------------------------------------------------


def cluster_assignment(num_clients: int, num_clusters: int, capability=None):
    """Static client -> cluster map: (cidx [M], C), numpy.

    `num_clusters` is clamped to [1, M]. Without a capability profile the
    assignment is round-robin. With one ([M] relative compute speeds),
    clients are sorted by capability and greedily binned into C contiguous
    chunks, so similar-capability clients share a cluster [ParallelSFL,
    Liao et al. 2024]. Both keep the clusters balanced (sizes differ by at
    most one) without requiring M % C == 0; a constant profile keeps the
    round-robin map."""
    C = max(1, min(num_clusters, num_clients))
    if capability is not None:
        cap = np.asarray(capability, np.float64)
        if cap.shape != (num_clients,):
            raise ValueError(
                f"capability profile has shape {cap.shape}, "
                f"want ({num_clients},)")
        if np.ptp(cap) == 0:
            capability = None
    if capability is None:
        return np.arange(num_clients) % C, C
    order = np.argsort(-cap, kind="stable")  # fastest first, ties stable
    sizes = np.full(C, num_clients // C)
    sizes[: num_clients % C] += 1
    cidx = np.empty(num_clients, np.int64)
    start = 0
    for c, sz in enumerate(sizes):
        cidx[order[start:start + sz]] = c
        start += sz
    return cidx, C


def build_parallelsfl_round(model: Model, lr: float, num_clients: int,
                            local_steps: int) -> Callable:
    """One ParallelSFL ROUND [Liao et al., 2024]: C balanced clusters, each
    split-federating against its OWN server replica. Every local step each
    client takes a split step (tower: local SGD; its cluster's replica: one
    step on the mean of its active members' server gradients); at round end
    the towers fed-average within each cluster and the C replicas merge
    globally. params: {"towers": [M, ...], "servers": [C, ...], "cidx":
    [M] int}: the client -> cluster map and C live in the state. A cluster
    with no active member holds its replica (and, at round end, its
    towers)."""
    return compose_phases(
        build_parallelsfl_phases(model, lr, num_clients, local_steps),
        lambda: full_schedule(num_clients, local_steps))


def _cluster_onehot(cidx, C: int):
    """[C, M] f32 membership of each cluster."""
    return (cidx[None, :] == torch.arange(C, device=cidx.device)[:, None]).float()


def _cluster_wmean(xs, w, onehot):
    """[M, ...] values (a list), [M] weights -> ([C, ...] weighted means
    over each cluster's members (all-zero clusters -> 0), one per value;
    [C] weight sums). A fixed-order masked sum per cluster (the
    reference's segment_sum): deterministic on the card, where index_add
    is not. The sums and weight totals are summed over the client group
    (one all-reduce per dtype under a mesh)."""
    sums = []
    for x in xs:
        xw = x * broadcast_weights(w, x)
        sums.append(torch.stack([(xw * broadcast_weights(onehot[c], xw)).sum(0)
                                 for c in range(onehot.shape[0])]))
    wc, *sums = client_sum_([(onehot * w[None, :]).sum(1), *sums])
    return [s / broadcast_weights(torch.clamp(wc, min=1.0), s) for s in sums], wc


def build_parallelsfl_phases(model: Model, lr: float, num_clients: int,
                             local_steps: int) -> PhaseProgram:
    """ParallelSFL as a phase program: `local` is the per-step cluster
    split loop (towers and the C replicas train jointly: the replicas are
    shared payload); `apply` is the round-end within-cluster tower
    federation and the global replica merge over the participants."""
    vg = _client_value_and_grad(model)

    def local_phase(params, batch, schedule: ClientSchedule):
        cidx = params["cidx"]
        C = tree_leaves(params["servers"])[0].shape[0]
        mask, budget, _ = schedule_tensors(schedule, cidx.device)
        act = step_activity(mask, budget, local_steps)  # [k, M]
        smask = schedule_sample_mask(schedule, batch)
        onehot = _cluster_onehot(cidx, C)
        towers, servers = _copy(params["towers"]), _copy(params["servers"])
        tl, sl = tree_leaves(towers), tree_leaves(servers)
        per = []
        for t in range(local_steps):
            a = act[t]
            servers_pc = tree_map(lambda s: s[cidx], servers)  # [M, ...]
            losses, grads = vg({"tower": towers, "server": servers_pc},
                               _step_batch(batch, t), smask)
            # a cluster with no active member this step holds its replica
            gms, wc = _cluster_wmean(tree_leaves(grads["server"]), a, onehot)
            live = lr * (wc > 0).float()  # [C]
            _sgd_step(tl + sl, tree_leaves(grads["tower"]) + gms,
                      [lr * a] * len(tl) + [live] * len(sl))
            per.append(losses)
        return {"towers": towers, "servers": servers, "per": torch.stack(per)}

    def apply_phase(params, payload, schedule: ClientSchedule):
        cidx = params["cidx"]
        C = tree_leaves(params["servers"])[0].shape[0]
        mask, _, _ = schedule_tensors(schedule, cidx.device)
        onehot = _cluster_onehot(cidx, C)
        # fed-average towers within each cluster over the round's
        # participants (idle clusters hold), merge the replicas of clusters
        # that trained and give the result to all C
        xs = tree_leaves(payload["towers"])
        means, wc = _cluster_wmean(xs, mask, onehot)  # wc [C]
        has = (wc > 0).to(mask.dtype)
        towers = tree_unflatten_like(payload["towers"], [
            torch.where(broadcast_weights(wc[cidx] > 0, x), m[cidx], x)
            for x, m in zip(xs, means)])
        # the replicas' merge is over the replicated cluster axis
        servers = tree_map(lambda s: participation_bcast_mean(s, has, clients=False),
                           payload["servers"])
        return ({"towers": towers, "servers": servers, "cidx": cidx},
                _round_metrics(payload["per"][-1] * mask))

    return PhaseProgram(local_phase, apply_phase)


def eval_parallelsfl(model: Model, num_clients: int):
    """Eval {"towers": [M, ...], "servers": [C, ...], "cidx": [M]}: client
    m is served by its cluster's replica, by the map stored in the state."""
    acc = _client_accuracy(model)

    @torch.no_grad()
    def eval_fn(params, batch):
        cidx = params["cidx"]
        servers_pc = tree_map(lambda s: s[cidx], params["servers"])
        inputs = {k: v for k, v in batch.items() if k != "label"}
        accs = gather_clients(client_map(acc, params["towers"], servers_pc, inputs,
                                         batch["label"]))
        return {"per_task_acc": accs, "acc_mtl": accs.mean()}

    return eval_fn


# ---------------------------------------------------------------------------
# smofi: splitfed with step-wise server-side momentum fusion
# ---------------------------------------------------------------------------


def build_smofi_round(model: Model, lr: float, num_clients: int,
                      local_steps: int, momentum: float) -> Callable:
    """One SMoFi ROUND [Yang et al., 2025]: splitfed whose per-client
    server replicas fuse their heavy-ball momentum buffers every local step;
    the towers fed-average at round end and the fused momentum persists.
    The replicas share one init and every step applies the same fused
    update, so they stay equal: the state stores the server and the buffer
    once (v <- beta·v + mean_m g_m, over the ACTIVE clients; a step with
    no active client holds both). state: {"towers": [M, ...], "server":
    ..., "smom": ...}."""
    return compose_phases(
        build_smofi_phases(model, lr, num_clients, local_steps, momentum),
        lambda: full_schedule(num_clients, local_steps))


def build_smofi_phases(model: Model, lr: float, num_clients: int,
                       local_steps: int, momentum: float) -> PhaseProgram:
    """SMoFi as a phase program: `local` is the per-step momentum-fused
    split loop (the shared server and buffer are payload beside the
    per-client towers); `apply` federates the towers over the participants
    and commits server and momentum."""
    vg = _client_value_and_grad(model)

    def local_phase(state, batch, schedule: ClientSchedule):
        mask, budget, _ = schedule_tensors(schedule, _device(state))
        M = mask.shape[0]
        act = step_activity(mask, budget, local_steps)  # [k, M]
        any_act = (client_sum(act.sum(1)) > 0).float()  # [k]
        smask = schedule_sample_mask(schedule, batch)
        towers, server = _copy(state["towers"]), _copy(state["server"])
        smom = _copy(state["smom"])
        tl, sl = tree_leaves(towers), tree_leaves(server)
        per = []
        for t in range(local_steps):
            a = act[t]
            server_pc = tree_map(lambda s: s[None].expand((M,) + tuple(s.shape)),
                                 server)
            losses, grads = vg({"tower": towers, "server": server_pc},
                               _step_batch(batch, t), smask)
            # the fused buffer takes the ACTIVE clients' mean server gradient
            fused = tree_map(lambda v, g: momentum * v + g, smom,
                             participation_tree_mean(grads["server"], a))
            smom = tree_map(lambda n, o: torch.where(any_act[t] > 0, n, o),
                            fused, smom)
            _sgd_step(tl + sl, tree_leaves(grads["tower"]) + tree_leaves(smom),
                      [lr * a] * len(tl) + [lr * any_act[t:t + 1]] * len(sl))
            per.append(losses)
        return {"towers": towers, "server": server, "smom": smom,
                "per": torch.stack(per)}

    def apply_phase(state, payload, schedule: ClientSchedule):
        mask, _, _ = schedule_tensors(schedule, _device(state))
        towers = participation_tree_mean(payload["towers"], mask, bcast=True)
        return ({"towers": towers, "server": payload["server"],
                 "smom": payload["smom"]},
                _round_metrics(payload["per"][-1] * mask))

    return PhaseProgram(local_phase, apply_phase)


# ---------------------------------------------------------------------------
# fedem: mixture of K full models with per-client responsibilities
# ---------------------------------------------------------------------------


class FedEMState(NamedTuple):
    components: PyTree  # stacked [K, ...] full-model params {"tower","server"}
    pi: torch.Tensor  # [M, K] mixture weights per client
    opt_state: PyTree = ()  # build_fedem_train_step's optimizer state
    step: int = 0


def init_fedem_state(model: Model, gen: torch.Generator, num_clients: int,
                     num_components: int = 3):
    """(components: K independent full-model draws stacked [K, ...], pi:
    uniform [M, K])."""
    comps = stack_towers(
        lambda g: {"tower": model.init_tower(g), "server": model.init_server(g)},
        gen, num_components)
    pi = torch.full((num_clients, num_components), 1.0 / num_components,
                    dtype=torch.float32, device=gen.device)
    return comps, pi


def build_fedem_round(model: Model, lr: float, num_clients: int,
                      num_components: int, local_steps: int) -> Callable:
    """One FedEM ROUND [Marfoq et al. 2021]: each client computes its
    responsibilities over the K shared components and runs `local_steps`
    responsibility-weighted SGD steps on ALL K of them; then the components
    average over the participants and pi updates (non-participants keep
    theirs). fn(components, pi, batch, schedule=None) -> (components, pi,
    metrics)."""
    prog = build_fedem_phases(model, lr, num_clients, num_components,
                              local_steps)

    def round_fn(components, pi, batch, schedule: Optional[ClientSchedule] = None):
        if schedule is None:
            schedule = full_schedule(pi.shape[0], local_steps)
        payload = prog.local((components, pi), batch, schedule)
        (components, pi), metrics = prog.apply((components, pi), payload, schedule)
        return components, pi, metrics

    return round_fn


def build_fedem_phases(model: Model, lr: float, num_clients: int,
                       num_components: int, local_steps: int) -> PhaseProgram:
    """FedEM as a phase program over the state `(components, pi)`:
    `local` runs every client's responsibility-weighted local steps on its
    copies of the K components and returns {"comps": [M, K, ...], "r_mean":
    [M, K] mean responsibilities over the steps it ran}; `apply` averages
    the components over the participants and updates their
    responsibilities. The round metric `loss` is 0, as the reference's
    (eval recomputes the loss)."""
    vg = _client_value_and_grad(model)
    K = num_components

    def fold(x):  # [M, K, ...] -> [M·K, ...] (a view)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def per_component(x):  # [M, ...] -> [M·K, ...], each client's row K times
        return fold(x[:, None].expand((x.shape[0], K) + tuple(x.shape[1:])))

    def local_phase(state, batch, schedule: ClientSchedule):
        components, pi = state
        M = pi.shape[0]
        _, budget, _ = schedule_tensors(schedule, pi.device)
        smask = schedule_sample_mask(schedule, batch)
        active = _in_budget(budget, local_steps)  # [k, M]
        eta = lr * active
        comps = tree_map(
            lambda x: x[None].expand((M,) + tuple(x.shape)).contiguous(), components)
        ps = tree_leaves(comps)
        log_pi = torch.log(pi + 1e-12)
        sm = None if smask is None else per_component(smask)
        rs, step_r = [], []

        def objective(losses):
            # one block of whole clients (all of them without a chunk)
            lk = losses.reshape(-1, K)
            lo = sum(r.shape[0] for r in step_r)
            r = torch.softmax(log_pi[lo:lo + lk.shape[0]] - lk.detach(),
                              dim=-1)  # no gradient
            step_r.append(r)
            return (r * lk).sum()

        for t in range(local_steps):
            mb = {k: per_component(v) for k, v in _step_batch(batch, t).items()}
            _, grads = vg(tree_map(fold, comps), mb, sm, objective, group=K)
            rs.append(torch.cat(step_r))
            step_r.clear()
            _sgd_step(ps, tree_leaves(grads), [eta[t]] * len(ps))
        # mean responsibility over the steps each client actually ran
        r_mean = ((torch.stack(rs) * active[:, :, None]).sum(0)
                  / torch.clamp(active.sum(0), min=1.0)[:, None])
        return {"comps": comps, "r_mean": r_mean}

    def apply_phase(state, payload, schedule: ClientSchedule):
        _, pi = state
        mask, _, _ = schedule_tensors(schedule, pi.device)
        comps, r_mean = payload["comps"], payload["r_mean"]
        new_components = participation_tree_mean(comps, mask)
        r_norm = r_mean / r_mean.sum(-1, keepdim=True)
        # non-participants keep last round's responsibilities
        new_pi = torch.where(mask[:, None] > 0, r_norm, pi)
        return ((new_components, new_pi),
                {"loss": torch.zeros((), dtype=torch.float32, device=pi.device)})

    return PhaseProgram(local_phase, apply_phase)


def build_fedem_train_step(model: Model, base_optimizer, num_clients: int,
                           num_components: int = 3) -> Callable:
    """train_step(state, batch) -> (state, metrics): one synchronous EM
    step of the mixture on a [M, b, ...] batch (the single-step form;
    the registry's fedem runs `build_fedem_phases`). E-step:
    responsibilities r[k, m, b] ∝ pi[m, k]·exp(−loss of component k on
    sample (m, b)), without gradient. M-step: every component takes a
    responsibility-weighted gradient step through `base_optimizer`,
    applied in place through K1 (`per_component_lr(...).apply_`, one
    launch); pi <- mean over b of r."""
    from repro_torch.optim.per_component import per_component_lr

    M = num_clients
    classifier = _is_classifier(model)
    opt = per_component_lr(base_optimizer, lambda path: False)

    def per_sample_loss(comp, batch):
        """One component on every client's samples -> [M, b]."""
        inputs = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                  for k, v in batch.items() if k != "label"}
        logits, _ = model.server_forward(comp["server"],
                                         model.tower_forward(comp["tower"], inputs))
        logits = _at_least_f32(logits)
        if classifier:
            nll = _nll(logits, batch["label"].reshape(-1))
        else:
            tokens = inputs["tokens"]
            nll = _nll(logits[:, :-1], tokens[:, 1:]).mean(-1)
        return nll.reshape(M, -1)

    components_loss = torch.func.vmap(per_sample_loss, in_dims=(0, None))

    def train_step(state: FedEMState, batch):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(state.components)]
        comps = tree_unflatten_like(state.components, leaves)
        if classifier:
            lkm = components_loss(comps, batch)  # [K, M, b]
        else:
            lkm = torch.stack([per_sample_loss(tree_map(lambda x, k=k: x[k], comps),
                                               batch)
                               for k in range(num_components)])
        log_r = torch.log(state.pi.T[:, :, None] + 1e-12) - lkm.detach()
        r = torch.softmax(log_r, dim=0)
        loss = (r * lkm).sum() / (M * lkm.shape[-1])
        grads = torch.autograd.grad(loss, leaves)
        opt_state = opt.apply_(state.components,
                               tree_unflatten_like(state.components, grads),
                               state.opt_state, state.step)
        pi = r.mean(-1).T  # [M, K]
        return (FedEMState(state.components, pi, opt_state, state.step + 1),
                {"loss": loss.detach(), "pi": pi})

    return train_step


def _nll(logits, labels):
    """-log softmax(logits)[label] over the last axis; the gold logit is
    picked by an elementwise comparison, not a gather, so the backward has
    no scatter (deterministic on the card)."""
    logz = torch.logsumexp(logits, dim=-1)
    hit = labels.long()[..., None] == torch.arange(logits.shape[-1],
                                                   device=logits.device)
    return logz - torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)


def build_fedem_eval_step(model: Model, num_clients: int) -> Callable:
    """Mixture prediction: per client, the pi-weighted average of the
    components' class probabilities (classifiers)."""
    if not _is_classifier(model):
        raise NotImplementedError("FedEM eval is implemented for classifiers")

    def comp_probs(comp, flat_in):
        logits, _ = model.server_forward(comp["server"],
                                         model.tower_forward(comp["tower"], flat_in))
        return torch.softmax(logits.float(), dim=-1)

    probs_fn = torch.func.vmap(comp_probs, in_dims=(0, None))

    @torch.no_grad()
    def eval_step(state: FedEMState, batch):
        M = state.pi.shape[0]
        inputs = {k: v for k, v in batch.items() if k != "label"}
        flat_in = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in inputs.items()}
        probs = probs_fn(state.components, flat_in)  # [K, M·b, C]
        probs = probs.reshape(probs.shape[0], M, -1, probs.shape[-1])
        mixed = torch.einsum("kmbc,mk->mbc", probs, state.pi)
        correct = (mixed.argmax(-1) == batch["label"].long()).float()
        per_task_acc = gather_clients(correct.mean(1))
        return {"per_task_acc": per_task_acc, "acc_mtl": per_task_acc.mean()}

    return eval_step
