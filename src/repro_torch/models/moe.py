"""Mixture-of-Experts layer (port of `repro.models.moe`): top-k router,
capacity-bounded sort-based dispatch, shared experts, the Switch-style
load-balance auxiliary loss.

The function is the reference's: the router in f32 (softmax, top-k,
renormalised gates), a stable sort of the (token, choice) rows by expert,
each expert taking the first C rows of its segment (later rows are
dropped), the three expert products as batched matmuls over the `[E, d, f]`
stacks (outside any kernel, as the reference leaves them to XLA), and the
gate-weighted combine.

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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import param_dtype, rmsnorm, rmsnorm_params
from repro_torch.nn import param


def moe_params(gen, cfg: ModelConfig):
    """The training tree (the MoE block has no serving path yet): the router
    in f32, the expert stacks [E, d, f] / [E, f, d] in cfg.param_dtype."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = param_dtype(cfg)
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


def _dispatch_group(p, ht, cfg: ModelConfig, C: int):
    """Route one token group [T, d] through the experts. Returns (y, aux)."""
    cdt = ht.dtype
    T, d = ht.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = ht.device

    # ---- router (f32)
    probs = torch.softmax(ht.float() @ p["router"].float(), dim=-1)  # [T, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [T, k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # ---- load-balance aux loss (Switch-style)
    me = probs.mean(0)  # [E] mean router probability
    ce = F.one_hot(gate_idx, E).float().sum(1).mean(0)  # [E] share routed
    aux = E * (me * ce).sum()

    # ---- stable sort of the T*k rows by expert; expert e takes the first
    # C rows of its segment
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    experts = torch.arange(E, device=dev)
    seg_start = torch.searchsorted(e_sorted, experts, side="left")  # [E]
    seg_count = torch.searchsorted(e_sorted, experts, side="right") - seg_start
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[e_sorted]
    keep = pos_in_e < C
    if moe_forward.tally is not None:
        kept = keep.sum()
        moe_forward.tally.append(torch.stack([kept, kept.new_full((), T * k)]))

    # dispatch: slot (e, c) holds sorted row seg_start[e] + c, or the zero
    # pad row T*k when expert e has fewer than c + 1 rows
    c_idx = torch.arange(C, device=dev)
    filled = c_idx[None, :] < seg_count[:, None]  # [E, C]
    row_of = torch.where(filled, seg_start[:, None] + c_idx[None, :], T * k)
    x_rows = ht[:, None, :].expand(T, k, d).reshape(T * k, d)[order]
    x_pad = torch.cat([x_rows, x_rows.new_zeros(1, d)])
    expert_in = x_pad[row_of.reshape(-1)].reshape(E, C, d)

    # ---- expert FFN (batched matmuls over the stacked weights)
    g = torch.bmm(expert_in, p["wg"].to(cdt))
    u = torch.bmm(expert_in, p["wu"].to(cdt))
    out = torch.bmm(F.silu(g) * u, p["wd"].to(cdt)).reshape(E * C, d)

    # ---- combine: row r = (t, j) reads its slot (a zero pad row when
    # dropped), weighted by its gate; each token sums its k rows in order
    slot_sorted = torch.where(keep, e_sorted * C + pos_in_e, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    out_pad = torch.cat([out, out.new_zeros(1, d)])
    rows = out_pad[slot].reshape(T, k, d)
    y = (rows * gate_vals.to(cdt)[..., None]).sum(1)
    return y, aux


def moe_forward(p, x, cfg: ModelConfig):
    """x: [..., S, d] -> (y, aux_loss). Flattens leading dims into tokens.

    cfg.moe_groups > 1 splits the tokens into independent dispatch groups,
    each with its own capacity (aux is their mean), as the reference."""
    orig_shape = x.shape
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    d = orig_shape[-1]
    ht = h.reshape(-1, d)  # [T, d]
    T = ht.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    G = max(cfg.moe_groups, 1)
    if T % G != 0:
        G = 1

    if G == 1:
        y, aux = _dispatch_group(p, ht, cfg, _capacity(T, E, k, cfg.capacity_factor))
    else:
        Tg = T // G
        C = _capacity(Tg, E, k, cfg.capacity_factor)
        parts = [_dispatch_group(p, hg, cfg, C) for hg in ht.reshape(G, Tg, d)]
        y = torch.cat([yg for yg, _ in parts])
        aux = torch.stack([a for _, a in parts]).mean()

    # ---- shared experts (dense path)
    if "shared" in p:
        cdt = ht.dtype
        sg = ht @ p["shared"]["wg"].to(cdt)
        su = ht @ p["shared"]["wu"].to(cdt)
        y = y + (F.silu(sg) * su) @ p["shared"]["wd"].to(cdt)
    return y.reshape(orig_shape), aux


# dispatch statistics: while a list, each dispatch group appends a [2]
# int64 tensor (rows kept, rows routed) on the input's device, without a
# host sync; None (the default) records nothing
moe_forward.tally = None
