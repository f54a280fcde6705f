"""MTSL train/eval step builders, the paper's Alg. 1 (port of
`repro.core.mtsl`, its dense path for the classifier families).

One round:
  * the client towers run mapped over the leading client axis
    (`torch.func.vmap`: private compute, one stacked parameter tree);
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

The reference's `client_axis` chunking (a scan over client blocks) and
the LM families' losses are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import schedule as schedule_mod
from repro_torch.core.split import is_client_path, stack_towers
from repro_torch.models.registry import Model
from repro_torch.optim.per_component import ComponentLR, per_component_lr
from repro_torch.utils.tree import tree_leaves, tree_map

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


def make_loss_fn(model: Model, num_clients: int) -> Callable:
    """loss_fn(params, batch, participation=None, sample_mask=None,
    sample_denom=None) -> (loss, metrics), for the classifier families.

    batch: {"image": [M, b, ...], "label": [M, b]} on the params' device.
    Loss = sum over tasks of per-task mean loss (paper Eq. 2). An optional
    `participation` mask [M] of {0,1} weights the per-task sum AND stops
    gradient through masked-out clients' smashed activations, so a
    masked-out client's tower receives exactly zero gradient and the
    server sees only participants' task gradients. All-ones is
    bit-identical to no mask.

    `sample_mask` ([M, b] {0,1}, capability-aware batch sizing) makes
    client m's per-task loss the mean over its first sizes[m] samples;
    `sample_denom` ([M]) overrides that mean's denominator (gradient
    accumulation passes live_samples / microbatches; guarded by 1e-9, not
    clamped to 1, so a size-0 client adds nothing to the accuracy
    denominator either)."""
    cfg = model.cfg
    M = num_clients
    if cfg.family not in ("mlp", "resnet"):
        raise NotImplementedError(
            f"the mtsl loss of family {cfg.family!r} is not ported yet")
    towers_fwd = torch.func.vmap(model.tower_forward)

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
                    s, s.detach()),
                smashed)
        # --- smashed-data upload: fold the client dim into the batch
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), smashed)
        logits, aux = model.server_forward(params["server"], flat)
        labels = batch["label"]
        # at least f32 (bf16 logits go up; an f64 tree stays f64, which a
        # precision witness of the f32 round needs)
        logits32 = logits.to(torch.promote_types(logits.dtype, torch.float32))
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
        opt_state = opt.apply_(state.params, grads, state.opt_state,
                               state.step, component_lr, participation)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return local_step, apply_step


def build_eval_step(model: Model, num_clients: int) -> Callable:
    """eval_step(params, batch) -> per-task accuracy (paper Eq. 14):
    {"per_task_acc": [M], "acc_mtl": mean over tasks}."""
    M = num_clients
    if model.cfg.family not in ("mlp", "resnet"):
        raise NotImplementedError(
            f"the mtsl eval of family {model.cfg.family!r} is not ported yet")
    towers_fwd = torch.func.vmap(model.tower_forward)

    @torch.no_grad()
    def eval_step(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "label"}
        smashed = towers_fwd(params["towers"], inputs)
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), smashed)
        logits, _ = model.server_forward(params["server"], flat)
        preds = logits.float().argmax(-1).reshape(M, -1)
        per_task_acc = (preds == batch["label"].long()).float().mean(1)
        return {"per_task_acc": per_task_acc, "acc_mtl": per_task_acc.mean()}

    return eval_step
