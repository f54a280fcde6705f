"""Mixture-of-Experts layer (port of `repro.models.moe`): top-k router,
capacity-bounded sort-based dispatch, shared experts, the Switch-style
load-balance auxiliary loss.

The function is the reference's: the router in f32 (softmax, top-k,
renormalised gates), a stable sort of the (token, choice) rows by expert,
each expert taking the first C rows of its segment (later rows are
dropped), the three expert products as batched matmuls over the `[E, d, f]`
stacks (outside any kernel, as the reference leaves them to XLA), and the
gate-weighted combine. Dispatch groups (cfg.moe_groups, or one per row of
a decode over slots) are dispatched together: their sorts and gathers are
batched over the group axis, and each expert's product takes every
group's slots at once, so the expert weights are read once per call.

Seeded runs are bit-reproducible on the card, so nothing here sums through
atomics in an order that changes between runs. The reference scatters
(`row_of.at[dst].set`, `y.at[tok_of].add`); the port gathers instead:
  * dispatch: the rows are permuted into expert order (a gather whose
    backward writes each row once) and each expert slot reads its row of
    that order (each row read by at most one slot);
  * combine: each token gathers the outputs of its k slots and sums them
    in choice order, a fixed-order reduction.
Every gradient that a backward scatters lands on a distinct row, except in
the zero pad rows that stand for empty or dropped slots, which nothing
reads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_params, weight_dtype
from repro_torch.nn import param


def moe_params(gen, cfg: ModelConfig, serving: bool = False):
    """The router in f32 (the reference routes in f32), the expert stacks
    [E, d, f] / [E, f, d] and the shared experts in cfg.param_dtype, or in
    cfg.dtype in a serving tree (`models/layers.py`)."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = weight_dtype(cfg, serving)
    p = {
        "router": param(gen, (d, E), dtype=torch.float32),
        "wg": param(gen, (E, d, f), dtype=dt, fan_in=d),
        "wu": param(gen, (E, d, f), dtype=dt, fan_in=d),
        "wd": param(gen, (E, f, d), dtype=dt, fan_in=f),
        "norm": rmsnorm_params(gen, d),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "wg": param(gen, (d, fs), dtype=dt),
            "wu": param(gen, (d, fs), dtype=dt),
            "wd": param(gen, (fs, d), dtype=dt),
        }
    return p


def _capacity(T: int, E: int, k: int, factor: float) -> int:
    c = int((T * k * factor) / E) + 1
    # round up to a multiple of 8, as the reference
    return max(8, -(-c // 8) * 8)


def _dispatch(p, ht, cfg: ModelConfig, C: int):
    """Route G independent token groups ht [G, T, d] through the experts,
    each group with its own capacity C per expert (the reference's vmap
    over groups). Returns (y [G, T, d], aux [G])."""
    cdt = ht.dtype
    G, T, d = ht.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = ht.device
    grp = torch.arange(G, device=dev)[:, None]

    # ---- router (f32)
    probs = torch.softmax(ht.float() @ p["router"].float(), dim=-1)  # [G, T, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [G, T, k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # ---- load-balance aux loss (Switch-style)
    me = probs.mean(1)  # [G, E] mean router probability
    ce = F.one_hot(gate_idx, E).float().sum(2).mean(1)  # [G, E] share routed
    aux = E * (me * ce).sum(-1)

    # ---- stable sort of each group's T*k rows by expert; expert e takes
    # the first C rows of its segment
    flat_e = gate_idx.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e[grp, order]
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    seg_start = torch.searchsorted(e_sorted, experts, side="left")  # [G, E]
    seg_count = torch.searchsorted(e_sorted, experts, side="right") - seg_start
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[grp, e_sorted]
    keep = pos_in_e < C
    if moe_forward.tally is not None:
        kept = keep.sum()
        moe_forward.tally += torch.stack([kept, kept.new_full((), G * T * k)])

    # dispatch: slot (e, c) of a group holds its sorted row seg_start[e] +
    # c, or the zero pad row T*k when expert e has fewer than c + 1 rows
    c_idx = torch.arange(C, device=dev)
    filled = c_idx < seg_count[..., None]  # [G, E, C]
    row_of = torch.where(filled, seg_start[..., None] + c_idx, T * k)
    x_rows = ht[:, :, None, :].expand(G, T, k, d).reshape(G, T * k, d)[grp, order]
    x_pad = torch.cat([x_rows, x_rows.new_zeros(G, 1, d)], dim=1)
    expert_in = x_pad[grp, row_of.reshape(G, E * C)].reshape(G, E, C, d)
    # every group's rows of expert e in one product: [E, G*C, d]
    expert_in = expert_in.transpose(0, 1).reshape(E, G * C, d)

    # ---- expert FFN (batched matmuls over the stacked weights)
    g = torch.bmm(expert_in, p["wg"].to(cdt))
    u = torch.bmm(expert_in, p["wu"].to(cdt))
    out = torch.bmm(F.silu(g) * u, p["wd"].to(cdt))
    out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: row r = (t, j) reads its slot (a zero pad row when
    # dropped), weighted by its gate; each token sums its k rows in order
    slot_sorted = torch.where(keep, e_sorted * C + pos_in_e, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    out_pad = torch.cat([out, out.new_zeros(G, 1, d)], dim=1)
    rows = out_pad[grp, slot].reshape(G, T, k, d)
    y = (rows * gate_vals.to(cdt)[..., None]).sum(2)
    return y, aux


def rank_moe_groups(cfg: ModelConfig, shards: int) -> int:
    """The dispatch groups a rank holding 1/`shards` of the client axis
    takes for its own tokens, so that its groups are exactly the dense
    round's groups over its rows: cfg.moe_groups / shards. Expert capacity
    is computed per group, so a cfg.moe_groups that is not a multiple of
    the shard count (moe_groups = 1 above all: one group over every
    client's tokens) has no such split, and the rank would drop other
    tokens than the dense round: refused."""
    if not cfg.num_experts or shards == 1:
        return cfg.moe_groups
    if cfg.moe_groups % shards:
        raise ValueError(
            f"moe_groups={cfg.moe_groups} is not a multiple of the mesh's "
            f"client-shard count {shards}: expert capacity is computed per "
            "dispatch group, so a rank routing only its own clients' tokens "
            "would drop other tokens than the unsharded round (set "
            f"moe_groups to a multiple of {shards})")
    return cfg.moe_groups // shards


def moe_forward(p, x, cfg: ModelConfig, groups: Optional[int] = None):
    """x: [..., S, d] -> (y, aux_loss). Flattens leading dims into tokens.

    cfg.moe_groups > 1 splits the tokens into independent dispatch groups,
    each with its own capacity (aux is their mean), as the reference.
    `groups` overrides it: a decode over B slots whose rows are separate
    requests passes groups=B, so each token is dispatched alone, as the
    reference's continuous engine vmaps its tower decode over slots."""
    orig_shape = x.shape
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    d = orig_shape[-1]
    ht = h.reshape(-1, d)  # [T, d]
    T = ht.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    G = max(cfg.moe_groups, 1) if groups is None else groups
    if T % G != 0:
        G = 1
    C = _capacity(T // G, E, k, cfg.capacity_factor)
    y, aux = _dispatch(p, ht.reshape(G, T // G, d), cfg, C)
    y, aux = y.reshape(T, d), aux.mean()

    # ---- shared experts (dense path)
    if "shared" in p:
        cdt = ht.dtype
        sg = ht @ p["shared"]["wg"].to(cdt)
        su = ht @ p["shared"]["wu"].to(cdt)
        y = y + (F.silu(sg) * su) @ p["shared"]["wd"].to(cdt)
    return y.reshape(orig_shape), aux


# dispatch statistics: while an int64 [2] tensor on the input's device,
# each call adds (rows kept, rows routed, over its groups) to it in place,
# without a host sync (in place, so a CUDA graph that captured the call
# adds on every replay: set it before an engine captures its steps, and
# zero it rather than replace it); None (the default) records nothing
moe_forward.tally = None
