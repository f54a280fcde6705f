"""Host-driven chunked MTSL round (port of `repro.core.scan_round`): the
round as a host loop over M/chunk client blocks, calling three per-block
functions whose shapes depend only on (model, chunk, batch width,
optimizer), so runs at different M with the same chunk share them.

The reference jits the three functions, and its `scan_round_compile_counts`
counts their compiled shapes. The port runs eagerly and has no compile to
count: its functions are built once per (model, chunk, optimizer)
(`mtsl_scan_kernels`, cached), and every round at any M with that key runs
the same three (`round_fn.kernels`). Nothing in the loop or the launcher
calls this round; the chunked round (`shard_round_fn(client_chunk=)`) is
the port's chunked path. It stays beside it as the reference's host scan
round, held against it in the tests.

The decomposition is exact for the MTSL round because the round is
additive over clients given the shared server:

  grads    one block's tower grads are self-contained; the server grad is
           the SUM of the blocks' server grads (the implicit aggregation);
  towers   sgd/momentum/adamw updates are element-wise per leaf, so a
           block's towers and optimizer moments update from that block's
           grads alone (per-client LRs and the participation freeze are
           per-row step sizes of K1, sliced along);
  server   one update from the summed server grad, scaled by the server
           component LR: the dense round's server step.

Every update goes through K1 (`per_component_lr(...).apply_`, one
`mtsl_update_multi_` launch): one for each block's towers, updated in
place through views of the state's [M, ...] leaves, and one for the
server, so a round makes M/chunk + 1 launches. Matches the dense mtsl
round up to float reduction order (`acc` as the mean of equal-width block
means).

Restrictions (ValueError): hp.microbatches must be 1 and the schedule must
not carry capability batch sizes (`schedule.sizes`). Participation masks
and straggler budgets are fine (mtsl rounds are single-step, so the
budget is moot, as in core/algorithms._mtsl_round).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import lr_policy
from repro_torch.core.mtsl import TrainState, make_loss_fn
from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.optim.per_component import ComponentLR, per_component_lr
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

PyTree = Any

@functools.lru_cache(maxsize=None)
def _default_sgd(lr: float) -> Optimizer:
    """One Optimizer instance per lr, so the function cache below keys
    stably."""
    return sgd(lr)


def _is_ps(x) -> bool:
    """A params-shaped dict inside an optimizer state."""
    return isinstance(x, dict) and set(x.keys()) == {"towers", "server"}


def _map_opt(fn: Callable, tree, *rest):
    """Map `fn` over the params-shaped dicts (and plain leaves) of an
    optimizer state: () for sgd, a params dict for momentum, an AdamState
    of two for adamw."""
    if _is_ps(tree) or not isinstance(tree, (tuple, list)):
        return fn(tree, *rest)
    vals = [_map_opt(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _opt_part(opt_state, key: str):
    """The optimizer state's `key` ("towers" or "server") component."""
    return _map_opt(lambda d: d[key] if _is_ps(d) else d, opt_state)


def _opt_join(template, towers_state, server_state):
    """Inverse of `_opt_part`."""
    return _map_opt(lambda d, t, s: {"towers": t, "server": s} if _is_ps(d) else s,
                    template, towers_state, server_state)


def _tree_rows(tree, sl):
    """Rows `sl` of every tensor of a (component) optimizer state or tree."""
    if isinstance(tree, dict):
        return {k: _tree_rows(v, sl) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [_tree_rows(v, sl) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree[sl] if torch.is_tensor(tree) else tree


def _tree_cat(parts: list):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _tree_cat([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        vals = [_tree_cat([p[i] for p in parts]) for i in range(len(first))]
        return type(first)(*vals) if hasattr(first, "_fields") else type(first)(vals)
    return torch.cat(parts) if torch.is_tensor(first) else first


class ScanKernels(NamedTuple):
    grads: Callable  # (towers_c, server, batch_c, mask_c) -> (tg, sg, metrics)
    tower_update: Callable  # (towers_c, opt_c, tg, lr_c, mask_c, step) -> opt_c
    server_update: Callable  # (server, opt_s, sg, lr_s, step) -> opt_s


@functools.lru_cache(maxsize=None)
def mtsl_scan_kernels(model, chunk: int, opt: Optimizer) -> ScanKernels:
    """The three per-block functions, built once per (model, chunk, opt):
    every M sharing these shares them."""
    loss_fn = make_loss_fn(model, chunk)
    towers_opt = per_component_lr(opt, lambda path: True)
    server_opt = per_component_lr(opt, lambda path: False)

    def grads(towers_c, server, batch_c, mask_c):
        t_req = [x.detach().requires_grad_() for x in tree_leaves(towers_c)]
        s_req = [x.detach().requires_grad_() for x in tree_leaves(server)]
        params = {"towers": tree_unflatten_like(towers_c, t_req),
                  "server": tree_unflatten_like(server, s_req)}
        loss, metrics = loss_fn(params, batch_c, mask_c)
        g = torch.autograd.grad(loss, t_req + s_req)
        return (tree_unflatten_like(towers_c, g[:len(t_req)]),
                tree_unflatten_like(server, g[len(t_req):]),
                {k: v.detach() if torch.is_tensor(v) else v
                 for k, v in metrics.items()})

    def tower_update(towers_c, opt_c, tg, lr_c, mask_c, step):
        # per-client LRs and the participation freeze: K1's per-row step
        # sizes, as per_component_lr's apply_ gives the dense round's towers
        clr = ComponentLR(server=lr_c.new_ones(()), clients=lr_c)
        return towers_opt.apply_(towers_c, tg, opt_c, step, clr, mask_c)

    def server_update(server, opt_s, sg, lr_s, step):
        clr = ComponentLR(server=lr_s, clients=lr_s.reshape(1))
        return server_opt.apply_(server, sg, opt_s, step, clr)

    return ScanKernels(grads, tower_update, server_update)


def build_mtsl_scan_round(model, num_clients: int, hp, chunk: int):
    """round_fn(state: TrainState, batch, schedule=None) -> (state,
    metrics): the mtsl round as a host loop over num_clients/chunk client
    blocks (see the module docstring for semantics and restrictions)."""
    if num_clients % chunk:
        raise ValueError(
            f"num_clients {num_clients} not divisible by chunk {chunk}")
    if hp.microbatches != 1:
        raise ValueError(
            "build_mtsl_scan_round does not support gradient accumulation "
            f"(hp.microbatches={hp.microbatches}); use the chunked round "
            "(shard_round_fn) instead")
    opt = hp.optimizer if hp.optimizer is not None else _default_sgd(hp.lr)
    clr = hp.component_lr
    if clr is None:  # the paper's Eq. 9 policy, as in algorithms._mtsl_round
        clr = lr_policy.server_scaled(num_clients, server_scale=2.0 / num_clients)
    kernels = mtsl_scan_kernels(model, chunk, opt)
    n = num_clients // chunk
    is_classifier = model.cfg.family in ("mlp", "resnet")

    def round_fn(state: TrainState, batch, schedule=None):
        if schedule is not None and schedule.sizes is not None:
            raise ValueError(
                "build_mtsl_scan_round does not support capability batch "
                "sizes (schedule.sizes); use shard_round_fn instead")
        dev = tree_leaves(state.params)[0].device
        clients_lr = clr.clients.to(dev, torch.float32)
        server_lr = clr.server.to(dev, torch.float32)
        mask = (torch.ones((num_clients,), dtype=torch.float32, device=dev)
                if schedule is None
                else torch.as_tensor(schedule.mask, dtype=torch.float32, device=dev))
        towers, server = state.params["towers"], state.params["server"]
        opt_t = _opt_part(state.opt_state, "towers")
        opt_s = _opt_part(state.opt_state, "server")

        sg_sum, new_opt_t, pers, accs = None, [], [], []
        loss = aux = 0.0
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            towers_c = _tree_rows(towers, sl)  # views: updated in place
            tg, sg, metrics = kernels.grads(
                towers_c, server, {k: v[sl] for k, v in batch.items()}, mask[sl])
            sg_sum = (sg if sg_sum is None else tree_unflatten_like(
                sg, [a + b for a, b in zip(tree_leaves(sg_sum), tree_leaves(sg))]))
            new_opt_t.append(kernels.tower_update(
                towers_c, _tree_rows(opt_t, sl), tg, clients_lr[sl], mask[sl],
                state.step))
            pers.append(metrics["per_task"])
            loss = loss + metrics["loss"]
            aux = aux + metrics["aux"]
            if is_classifier:
                accs.append(metrics["acc"])
        opt_s = kernels.server_update(server, opt_s, sg_sum, server_lr, state.step)
        opt_state = _opt_join(state.opt_state, _tree_cat(new_opt_t), opt_s)
        metrics = {"loss": loss, "per_task": torch.cat(pers), "aux": aux}
        if is_classifier:
            # equal-width blocks: the mean of block means is the global mean
            metrics["acc"] = torch.stack(accs).mean()
        return TrainState(state.params, opt_state, state.step + 1), metrics

    round_fn.kernels = kernels
    return round_fn

