"""MTSL train/eval step builders, the paper's Alg. 1 (port of
`repro.core.mtsl`, its dense path, for the classifier families and every
LM family: "dense", "moe", "ssm", "hybrid", "vlm" and "encdec").

One round:
  * the client towers run mapped over the leading client axis (private
    compute, one stacked parameter tree): the classifiers under
    `torch.func.vmap`; the LMs as a Python loop over clients, each on its
    view of the stacked towers (`core.split.client_view`), the outputs
    stacked. An LM tower launches ctypes kernels, inside
    `torch.utils.checkpoint` under remat, which vmap cannot trace, and
    each client's tower has its own `A_log`, so the client axis cannot fold
    into the SSD kernel's batch either. The loop is the same function as
    the reference's `jax.vmap`;
  * the smashed-data upload is the activation boundary: the client dim
    folds into the batch;
  * the server stack runs on all clients' smashed data;
  * the loss is the sum over tasks of each task's mean cross-entropy
    (paper Eq. 2), with one backward pass;
  * per-component learning rates (eta_s, eta_1..eta_M) apply through the
    fused in-place update (optim/per_component.py, kernel K1).

Parameters live in a `TrainState` whose leaves require grad; the apply
step updates them in place (the reference donates their buffers instead),
so a round returns the state it was given, advanced.

Client chunking (core/client_axis.py): under `client_axis(chunk=c)` the
local step runs the clients in M/c blocks, each block's forward AND
backward before the next (`_chunked_grads`, the counterpart of the
reference's `_chunked_loss` / `_chunk_terms`), so only one block's
activations are live; the server's gradient is the sum of the blocks'
and the aux loss the sum of their aux terms, as in the reference's
chunked loss. The eval runs block by block too (`_chunk_eval`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import client_axis
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.split import client_view, is_client_path, stack_towers
from repro_torch.models.registry import Model
from repro_torch.optim.per_component import ComponentLR, per_component_lr
from repro_torch.utils.tree import (
    tree_align,
    tree_leaves,
    tree_map,
    tree_unflatten_like as tree_unflatten,
)

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree  # {"towers": [M,...], "server": ...}; leaves require grad
    opt_state: PyTree
    step: int


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _ce_logits(logits, labels, mask=None, denom=None):
    """Per-task mean cross-entropy over the last batch axis: logits
    [M, b, V] f32, labels [M, b] int -> [M]. `mask` [M, b] optionally
    selects live samples; `denom` [M] overrides the masked mean's
    denominator (gradient accumulation splits one live-sample mean across
    microbatches: each slice contributes its masked SUM over the shared
    denominator). The gold logit is picked by an elementwise comparison,
    not a gather, so the backward has no scatter (deterministic on the
    card)."""
    logz = torch.logsumexp(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    hit = labels.long()[..., None] == classes
    gold = torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
    nll = logz - gold
    if mask is None:
        return nll.mean(-1)
    d = torch.clamp(mask.sum(-1), min=1.0) if denom is None else denom
    return (nll * mask).sum(-1) / d


def _lm_loss(logits, tokens, smask=None, denom=None):
    """Per-task next-token CE. logits [M, b, S, V] f32, tokens [M, b, S]
    -> [M]. `smask` [M, b] optionally selects the live sequences of a
    padded batch (capability batch sizing); `denom` [M] is the
    _ce_logits denominator override in TOKENS."""
    M, _, S, V = logits.shape
    labels = tokens[..., 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    if smask is not None:
        mask = mask * smask[..., None]
    return _ce_logits(logits[:, :, :-1].reshape(M, -1, V),
                      labels.reshape(M, -1), mask.reshape(M, -1), denom)


def _at_least_f32(logits):
    """bf16 logits go up to f32; an f64 tree stays f64, which a precision
    witness of the f32 round needs."""
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def _is_classifier(cfg) -> bool:
    return cfg.family in ("mlp", "resnet")


def _towers_fn(model: Model, num_clients: int) -> Callable:
    """towers_fwd(towers, inputs) -> smashed {"h": [M, ...]}: the client
    towers over the leading client axis (see the module docstring)."""
    if _is_classifier(model.cfg):
        return torch.func.vmap(model.tower_forward)

    def towers_fwd(towers, inputs):
        outs = [model.tower_forward(client_view(towers, m),
                                    {k: v[m] for k, v in inputs.items()})
                for m in range(num_clients)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return towers_fwd


def make_loss_fn(model: Model, num_clients: int) -> Callable:
    """loss_fn(params, batch, participation=None, sample_mask=None,
    sample_denom=None) -> (loss, metrics).

    batch: {"image": [M, b, ...], "label": [M, b]} (classifiers; metrics
    loss, per_task, acc, aux) or {"tokens": [M, b, S]} (+ "vis" for the
    VLM, + "frames" for the encoder-decoder; LMs: next-token CE; metrics
    loss, per_task, aux) on the params' device.
    Loss = sum over tasks of per-task mean loss (paper Eq. 2) + the
    server's auxiliary loss (MoE router balance). An optional
    `participation` mask [M] of {0,1} weights the per-task sum AND stops
    gradient through masked-out clients' smashed activations (the float
    leaves; integer leaves such as the encoder-decoder's tokens pass
    through), so a masked-out client's tower receives exactly zero
    gradient and the server sees only participants' task gradients.
    The reference's documented limitation holds here too: the MoE aux
    loss is taken over ALL clients' smashed tokens, so non-participants'
    tokens still shape its value and its gradient into the server's
    parameters. All-ones is bit-identical to no mask.

    `sample_mask` ([M, b] {0,1}, capability-aware batch sizing) makes
    client m's per-task loss the mean over its first sizes[m] samples;
    `sample_denom` ([M]) overrides that mean's denominator (gradient
    accumulation passes live_samples / microbatches; guarded by 1e-9, not
    clamped to 1, so a size-0 client adds nothing to the accuracy
    denominator either)."""
    cfg = model.cfg
    M = num_clients
    is_classifier = _is_classifier(cfg)
    towers_fwd = _towers_fn(model, M)

    def loss_fn(params, batch, participation=None, sample_mask=None,
                sample_denom=None):
        inputs = {k: v for k, v in batch.items() if k != "label"}
        smashed = towers_fwd(params["towers"], inputs)
        if participation is not None:
            # sever non-participants' backward path; where() with an
            # all-true mask is the identity
            smashed = tree_map(
                lambda s: torch.where(
                    (participation > 0).reshape((M,) + (1,) * (s.ndim - 1)),
                    s, s.detach()) if s.is_floating_point() else s,
                smashed)
        # --- smashed-data upload: fold the client dim into the batch
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), smashed)
        logits, aux = model.server_forward(params["server"], flat)
        if not is_classifier:
            per_logits = _at_least_f32(logits).reshape(
                (M, -1) + tuple(logits.shape[1:]))
            tokens = batch["tokens"]
            if sample_mask is None:
                per = _lm_loss(per_logits, tokens)
            elif sample_denom is None:
                per = _lm_loss(per_logits, tokens, sample_mask)
            else:
                seq_tokens = tokens.shape[-1] - 1
                per = _lm_loss(per_logits, tokens, sample_mask,
                               torch.clamp(sample_denom * seq_tokens, min=1e-9))
            wper = per if participation is None else per * participation
            loss = wper.sum() + aux
            return loss, {"loss": loss, "per_task": per, "aux": aux}
        labels = batch["label"]
        logits32 = _at_least_f32(logits)
        per_logits = logits32.reshape(M, -1, logits.shape[-1])
        correct = (logits32.argmax(-1) == labels.reshape(-1).long()).float()
        if sample_mask is None:
            per = _ce_logits(per_logits, labels)
            acc = correct.mean()
        else:
            if sample_denom is None:
                per = _ce_logits(per_logits, labels, sample_mask)
                acc_denom = torch.clamp(sample_mask.sum(), min=1.0)
            else:
                per = _ce_logits(per_logits, labels, sample_mask,
                                 torch.clamp(sample_denom, min=1e-9))
                acc_denom = torch.clamp(sample_denom.sum(), min=1e-9)
            acc = (correct * sample_mask.reshape(-1)).sum() / acc_denom
        wper = per if participation is None else per * participation
        loss = wper.sum() + aux
        return loss, {"loss": loss, "per_task": per, "acc": acc, "aux": aux}

    return loss_fn


def _chunk_terms_fn(model: Model, c: int) -> Callable:
    """terms(params_c, batch_c, part_c, sm_c, sd_c) -> (per [c], the
    block's accuracy numerator, aux): one block of c clients' forward, the
    dense loss body with M -> c (the reference's `_chunk_terms`)."""
    is_classifier = _is_classifier(model.cfg)
    towers_fwd = _towers_fn(model, c)

    def terms(params, batch, part=None, sm=None, sd=None):
        inputs = {k: v for k, v in batch.items() if k != "label"}
        smashed = towers_fwd(params["towers"], inputs)
        if part is not None:
            smashed = tree_map(
                lambda s: torch.where(
                    (part > 0).reshape((c,) + (1,) * (s.ndim - 1)),
                    s, s.detach()) if s.is_floating_point() else s,
                smashed)
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), smashed)
        logits, aux = model.server_forward(params["server"], flat)
        logits32 = _at_least_f32(logits)
        if not is_classifier:
            per_logits = logits32.reshape((c, -1) + tuple(logits.shape[1:]))
            tokens = batch["tokens"]
            if sm is None:
                per = _lm_loss(per_logits, tokens)
            elif sd is None:
                per = _lm_loss(per_logits, tokens, sm)
            else:
                per = _lm_loss(per_logits, tokens, sm,
                               torch.clamp(sd * (tokens.shape[-1] - 1), min=1e-9))
            return per, torch.zeros((), dtype=torch.float32, device=per.device), aux
        labels = batch["label"]
        per_logits = logits32.reshape(c, -1, logits.shape[-1])
        if sm is None:
            per = _ce_logits(per_logits, labels)
        elif sd is None:
            per = _ce_logits(per_logits, labels, sm)
        else:
            per = _ce_logits(per_logits, labels, sm, torch.clamp(sd, min=1e-9))
        correct = (logits32.argmax(-1) == labels.reshape(-1).long()).float()
        w = torch.ones_like(correct) if sm is None else sm.reshape(-1)
        return per, (correct * w).sum(), aux

    return terms


def _chunked_grads(model: Model, num_clients: int, c: int, params, batch,
                   participation=None, smask=None, sdenom=None):
    """(metrics, grads) of the round's loss with the clients in blocks of
    c: each block's forward and backward run before the next block's, its
    tower gradients are its own and the server's gradient accumulates over
    the blocks (see the module docstring)."""
    M = num_clients
    terms = _chunk_terms_fn(model, c)
    t_leaves = tree_leaves(params["towers"])
    s_req = [x.detach().requires_grad_() for x in tree_leaves(params["server"])]
    server = tree_unflatten(params["server"], s_req)
    sg, tgs, pers = None, [], []
    acc_num = aux_sum = None
    for sl in client_axis.client_blocks(M, c):
        t_req = [x[sl].detach().requires_grad_() for x in t_leaves]
        p = {"towers": tree_unflatten(params["towers"], t_req), "server": server}
        part = None if participation is None else participation[sl]
        per, num, aux = terms(p, {k: v[sl] for k, v in batch.items()}, part,
                              None if smask is None else smask[sl],
                              None if sdenom is None else sdenom[sl])
        wper = per if part is None else per * part
        g = torch.autograd.grad(wper.sum() + aux, t_req + s_req)
        tgs.append(g[:len(t_req)])
        gs = g[len(t_req):]
        sg = list(gs) if sg is None else [a + b for a, b in zip(sg, gs)]
        pers.append(per.detach())
        aux = aux.detach() if torch.is_tensor(aux) else aux
        acc_num = num.detach() if acc_num is None else acc_num + num.detach()
        aux_sum = aux if aux_sum is None else aux_sum + aux
    per = torch.cat(pers)
    wper = per if participation is None else per * participation
    loss = wper.sum() + aux_sum
    grads = {"towers": tree_unflatten(params["towers"],
                                      [torch.cat(x) for x in zip(*tgs)]),
             "server": tree_unflatten(params["server"], sg)}
    metrics = {"loss": loss, "per_task": per, "aux": aux_sum}
    if _is_classifier(model.cfg):
        width = tree_leaves(batch)[0].shape[1]
        if smask is None:
            den = torch.tensor(float(M * width), device=per.device)
        elif sdenom is None:
            den = torch.clamp(smask.sum(), min=1.0)
        else:
            den = torch.clamp(sdenom.sum(), min=1e-9)
        metrics["acc"] = acc_num / den
    return metrics, grads


# ---------------------------------------------------------------------------
# state init
# ---------------------------------------------------------------------------


def init_state(model: Model, gen: torch.Generator, num_clients: int) -> PyTree:
    """{"towers": [M, ...]-stacked (one independent draw per client),
    "server": ...} on the generator's device, leaves requiring grad."""
    params = {"towers": stack_towers(model.init_tower, gen, num_clients),
              "server": model.init_server(gen)}
    return tree_map(lambda x: x.requires_grad_(), params)


def build_train_step(
    model: Model,
    base_optimizer,
    num_clients: int,
    microbatches: int = 1,
) -> Callable:
    """Returns train_step(state, batch, component_lr=None,
    participation=None, sample_sizes=None) -> (state, metrics), the
    composition of `build_train_phases`. `participation` is an optional
    [M] {0,1} float tensor: masked-out clients' towers get zero gradient
    and stay frozen. `sample_sizes` ([M] int tensor, capability-aware batch
    sizing) limits client m to the first sample_sizes[m] samples of its
    padded batch row; under gradient accumulation every microbatch divides
    by the shared live count sample_sizes / microbatches."""
    local_step, apply_step = build_train_phases(
        model, base_optimizer, num_clients, microbatches)

    def train_step(state: TrainState, batch,
                   component_lr: Optional[ComponentLR] = None,
                   participation=None, sample_sizes=None):
        grads, metrics = local_step(state, batch, participation, sample_sizes)
        return apply_step(state, grads, metrics, component_lr, participation)

    return train_step


def build_train_phases(
    model: Model,
    base_optimizer,
    num_clients: int,
    microbatches: int = 1,
) -> tuple:
    """`build_train_step` split at the smashed-gradient uplink.

    Returns (local_step, apply_step):
      local_step(state, batch, participation=None, sample_sizes=None)
          -> (grads, metrics): forward/backward (with the microbatch
          accumulation) against the round-start params.
      apply_step(state, grads, metrics, component_lr=None,
          participation=None) -> (TrainState, metrics): the per-component
          update, fused and in place (K1), participation tower freezing,
          step increment. (mtsl's sync transform is the identity.)"""
    loss_fn = make_loss_fn(model, num_clients)
    opt = per_component_lr(base_optimizer, is_client_path)

    def _grads(params, batch, participation=None, smask=None, sdenom=None):
        chunk = client_axis.current_chunk()
        if chunk is not None and chunk < num_clients:
            return _chunked_grads(model, num_clients, chunk, params, batch,
                                  participation, smask, sdenom)
        loss, metrics = loss_fn(params, batch, participation, smask, sdenom)
        leaves = tree_leaves(params)
        flat = torch.autograd.grad(loss, leaves)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        return tree_map(torch.Tensor.detach, metrics), grads

    def local_step(state: TrainState, batch, participation=None,
                   sample_sizes=None):
        width = tree_leaves(batch)[0].shape[1]
        smask = (None if sample_sizes is None
                 else schedule_mod.sample_mask(sample_sizes, width))
        if microbatches == 1:
            metrics, grads = _grads(state.params, batch, participation, smask)
            return grads, metrics
        if width % microbatches:
            raise ValueError(f"batch width {width} is not divisible by "
                             f"microbatches={microbatches}")
        w = width // microbatches
        # shared denominator per slice: the whole row's live count over
        # microbatches. Deliberately UNclamped: a masked-out client
        # (sizes=0) must add zero to the acc denominator too; make_loss_fn
        # guards the division with an epsilon
        sdenom = (None if sample_sizes is None
                  else sample_sizes.float() / microbatches)
        metrics = grads = None
        for j in range(microbatches):
            mb = tree_map(lambda x: x[:, j * w:(j + 1) * w].contiguous(), batch)
            sm = None if smask is None else smask[:, j * w:(j + 1) * w]
            m_j, g_j = _grads(state.params, mb, participation, sm, sdenom)
            if grads is None:
                metrics, grads = m_j, g_j
            else:
                grads = tree_map(torch.add, grads, g_j)
                metrics = tree_map(torch.add, metrics, m_j)
        inv = 1.0 / microbatches
        return (tree_map(lambda g: g * inv, grads),
                tree_map(lambda m: m * inv, metrics))

    def apply_step(state: TrainState, grads, metrics,
                   component_lr: Optional[ComponentLR] = None,
                   participation=None):
        opt_state = opt.apply_(state.params, tree_align(grads, state.params),
                               state.opt_state, state.step, component_lr,
                               participation)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return local_step, apply_step


def build_eval_step(model: Model, num_clients: int) -> Callable:
    """eval_step(params, batch) -> per-task metrics: the classifiers'
    accuracy (paper Eq. 14), {"per_task_acc": [M], "acc_mtl": mean over
    tasks}; the LMs' next-token loss, {"per_task_loss": [M], "loss": sum
    over tasks}."""
    M = num_clients
    is_classifier = _is_classifier(model.cfg)
    towers_fwd = _towers_fn(model, M)

    def _chunk_eval(params, batch, c):
        """The eval block by block (the reference's `_chunk_eval`)."""
        terms = _chunk_eval_fn(model, c)
        per = torch.cat([terms(tree_map(lambda x: x[sl], params["towers"]),
                               params["server"],
                               {k: v[sl] for k, v in batch.items()})
                         for sl in client_axis.client_blocks(M, c)])
        if is_classifier:
            return {"per_task_acc": per, "acc_mtl": per.mean()}
        return {"per_task_loss": per, "loss": per.sum()}

    @torch.no_grad()
    def eval_step(params, batch):
        chunk = client_axis.current_chunk()
        if chunk is not None and chunk < M and M % chunk == 0:
            return _chunk_eval(params, batch, chunk)
        inputs = {k: v for k, v in batch.items() if k != "label"}
        smashed = towers_fwd(params["towers"], inputs)
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), smashed)
        logits, _ = model.server_forward(params["server"], flat)
        if not is_classifier:
            per = _lm_loss(_at_least_f32(logits).reshape((M, -1) + tuple(logits.shape[1:])),
                           batch["tokens"])
            return {"per_task_loss": per, "loss": per.sum()}
        preds = logits.float().argmax(-1).reshape(M, -1)
        per_task_acc = (preds == batch["label"].long()).float().mean(1)
        return {"per_task_acc": per_task_acc, "acc_mtl": per_task_acc.mean()}

    return eval_step


def _chunk_eval_fn(model: Model, c: int) -> Callable:
    """per(towers_c, server, batch_c) -> [c]: one block's per-task accuracy
    (classifiers) or next-token loss (LMs)."""
    is_classifier = _is_classifier(model.cfg)
    towers_fwd = _towers_fn(model, c)

    def per(towers, server, batch):
        inputs = {k: v for k, v in batch.items() if k != "label"}
        smashed = towers_fwd(towers, inputs)
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), smashed)
        logits, _ = model.server_forward(server, flat)
        if not is_classifier:
            return _lm_loss(_at_least_f32(logits).reshape((c, -1) + tuple(logits.shape[1:])),
                            batch["tokens"])
        preds = logits.float().argmax(-1).reshape(c, -1)
        return (preds == batch["label"].long()).float().mean(1)

    return per
