"""The reference's first rounds of a training cell: plain float32 mtsl
rounds (`model.round_loss`) with SGD at the component rates (lr on a
client's tower, lr / M on the server), from the run's initial weights and
on the run's first round batches.

It records what the comparison reads: each round's loss, the norm of each
leaf's first gradient, and the norm of each leaf's change over the
rounds. Each layer's activations are recomputed in the backward, and each
leaf takes its step as soon as its gradient is whole (a hook), so the
weights, one layer's activations and one leaf's gradient are what is
live: a second model beside the first does not fit one card.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.lib.weights import Spec, initial_leaves, make_params
from perfbench.reference.model import round_loss


def eta(name: str, lr: float, num_clients: int) -> float:
    return lr if name.startswith("towers/") else lr / num_clients


def rounds(cfg: dict, spec: List[Spec], seed: int, batches: list, lr: float,
           num_clients: int, device, prec: str = "f32", half: bool = False) -> Dict:
    """{"loss": [per round], "grad": {leaf: first gradient's norm},
    "change": {leaf: ||w_after - w_0||}} over len(batches) rounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = make_params(spec, seed, device, requires_grad=True)
    first: Dict[str, torch.Tensor] = {}
    state = {"round": 0}

    def hook(name):
        step = eta(name, lr, num_clients)

        def apply(p):
            if state["round"] == 0:
                first[name] = p.grad.norm()
            p.data.add_(p.grad, alpha=-step)
            p.grad = None
        return apply

    handles = [p.register_post_accumulate_grad_hook(hook(n)) for n, p in params.items()]
    losses = []
    try:
        for i, batch in enumerate(batches):
            state["round"] = i
            tokens = torch.as_tensor(batch["tokens"], device=device).long()
            loss = round_loss(params, tokens, cfg, prec, remat=True, half=half)
            loss.backward()
            losses.append(loss.item())
    finally:
        for h in handles:
            h.remove()
    change = {n: (params[n].detach() - p0).norm()
              for n, p0 in initial_leaves(spec, seed, device)}
    names = sorted(params)
    grads = torch.stack([first.get(n, torch.zeros((), device=device)) for n in names])
    moved = torch.stack([change[n] for n in names])
    return {"loss": losses, "grad": dict(zip(names, grads.tolist())),
            "change": dict(zip(names, moved.tolist()))}
