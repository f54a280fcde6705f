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

The client axis across ranks: inside `round_tokens(group)` on a client
group of D ranks (`core.client_axis`), each rank holds a contiguous 1/D of the
call's tokens (the round's, or under a client chunk the chunk's: a rank's
block of the chunk, `utils.sharding.rank_rows`) and dispatches them as the
unsharded call would, for any
cfg.moe_groups (one group over every rank's tokens, a group a rank, or
groups that straddle ranks): one all-gather of each group's routed counts
per expert a layer gives every rank the rows lower ranks route ahead of
its own (see `_dispatch`).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import client_axis
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


def _group_sums(x, sizes):
    """x [T, E] -> [len(sizes), E]: the sums over consecutive runs of
    `sizes` rows (a fixed-order reduction, no atomics)."""
    if len(set(sizes)) == 1:
        return x.reshape(len(sizes), sizes[0], -1).sum(1)
    return torch.stack([c.sum(0) for c in x.split(sizes)])


def _dispatch(p, ht, cfg: ModelConfig, C: int, Tg: int, G: int, lo: int = 0,
              group=None):
    """Route the T tokens ht [T, d] through the experts: dispatch groups of
    Tg consecutive tokens (G of them in all), each with capacity C per
    expert, of which this call holds tokens lo .. lo + T - 1, and `group`
    (a `utils.sharding.ClientGroup`, None for one rank) the rest.
    Returns (y [T, d], this call's share of the aux loss).

    Each group's rows are flattened token-major and stable-sorted by
    expert; a row is kept iff its position in its expert's segment is
    below C (the reference's rule). Across ranks (`group`) a row's
    position is its position among this rank's rows plus the rows that
    lower ranks route to the same expert in the same group: one
    all-gather of the [G, E] routed counts gives both those prefixes and
    the groups' totals. No row leaves its rank.

    The aux loss is the mean over groups of E * sum_e me[e] * ce[e] (me the
    group's mean router probability, ce its routed share). A call returns
    E * sum_e (S[e] / Tg) * ce[e] / G summed over its groups, with S its
    own tokens' probability sums and ce the group's: the ranks' shares sum
    to the aux loss, and each differentiates only its own probabilities."""
    cdt = ht.dtype
    T, d = ht.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = ht.device
    g0 = lo // Tg
    sizes, t = [], lo  # this call's tokens in each group it touches
    while t < lo + T:
        hi = min((t // Tg + 1) * Tg, lo + T)
        sizes.append(hi - t)
        t = hi
    nG = len(sizes)

    # ---- router (f32)
    probs = torch.softmax(ht.float() @ p["router"].float(), dim=-1)  # [T, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # [T, k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # ---- stable sort of the rows by (group, expert); a row's position in
    # its (group, expert) segment, among this call's rows
    grp = (torch.arange(T, device=dev) + lo) // Tg - g0  # [T]
    key = (grp[:, None] * E + gate_idx).reshape(T * k)
    order = torch.argsort(key, stable=True)
    k_sorted = key[order]
    keys = torch.arange(nG * E, device=dev)
    seg_start = torch.searchsorted(k_sorted, keys, side="left")  # [nG*E]
    seg_count = torch.searchsorted(k_sorted, keys, side="right") - seg_start
    pos = torch.arange(T * k, device=dev) - seg_start[k_sorted]
    if group is None:
        routed, below = seg_count, None
    else:
        counts = seg_count.new_zeros(G, E)
        counts[g0:g0 + nG] = seg_count.reshape(nG, E)
        every = client_axis.gather_ranks(counts[None])[:, g0:g0 + nG].reshape(-1, nG * E)
        routed = every.sum(0)
        below = every[:group.index].sum(0)
        pos_all = pos + below[k_sorted]
    keep = (pos if below is None else pos_all) < C
    if moe_forward.tally is not None:
        kept = keep.sum()
        moe_forward.tally += torch.stack([kept, kept.new_full((), T * k)])

    # ---- load-balance aux loss (Switch-style), this call's share
    ce = routed.reshape(nG, E).float() / Tg
    share = E * (_group_sums(probs, sizes) / Tg * ce).sum() / G

    # dispatch: slot (g, e, c) holds the sorted row seg_start[g, e] + c, or
    # the zero pad row T*k when fewer than c + 1 of the segment's rows are
    # kept here. A rank keeps at most min(C, its tokens in g) rows of an
    # expert, and its slots per (group, expert) are as many as its fullest
    # segment keeps (read back: the shapes follow the routing, as the
    # kept rows do), so its expert products cover its own rows, not the
    # group's capacity; on meta tensors (the dry-run) the static bound
    room = seg_count.new_full((), C) if below is None else (C - below).clamp(min=0)
    n_keep = torch.minimum(seg_count, room).reshape(nG, E, 1)
    Cs = C
    if below is not None:
        Cs = min(C, max(sizes))
        if not n_keep.is_meta:
            Cs = min(Cs, max(8, -(-int(n_keep.max()) // 8) * 8))
    c_idx = torch.arange(Cs, device=dev)
    row_of = torch.where(c_idx < n_keep, seg_start.reshape(nG, E, 1) + c_idx, T * k)
    x_rows = ht[:, None, :].expand(T, k, d).reshape(T * k, d)[order]
    x_pad = torch.cat([x_rows, x_rows.new_zeros(1, d)])
    expert_in = x_pad[row_of.reshape(-1)].reshape(nG, E, Cs, d)
    # every group's rows of expert e in one product: [E, nG*Cs, d]
    expert_in = expert_in.transpose(0, 1).reshape(E, nG * Cs, d)

    # ---- expert FFN (batched matmuls over the stacked weights)
    g = torch.bmm(expert_in, p["wg"].to(cdt))
    u = torch.bmm(expert_in, p["wu"].to(cdt))
    out = torch.bmm(F.silu(g) * u, p["wd"].to(cdt))
    out = out.reshape(E, nG, Cs, d).transpose(0, 1).reshape(nG * E * Cs, d)

    # ---- combine: row r = (t, j) reads its slot (a zero pad row when
    # dropped), weighted by its gate; each token sums its k rows in order
    slot_sorted = torch.where(keep, k_sorted * Cs + pos, nG * E * Cs)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    out_pad = torch.cat([out, out.new_zeros(1, d)])
    rows = out_pad[slot].reshape(T, k, d)
    y = (rows * gate_vals.to(cdt)[..., None]).sum(1)
    return y, share


_ROUND_TOKENS: list = [None]


@contextmanager
def round_tokens(group):
    """Within the block, a moe_forward call without `groups` takes its
    tokens as this rank's contiguous block of the round's tokens, split
    evenly over `group` (a `utils.sharding.ClientGroup`, the client group
    of `core.client_axis`): the ranks' blocks, in rank order, are the
    tokens the unsharded call would get, and the call dispatches them as
    that call would (see `_dispatch`). None, or a group of one rank: the
    tokens are the call's own. mtsl's round and eval enter it around the
    server, which runs on every client's tokens at once (on every client
    of the chunk under a client chunk, whose capacity is the chunk's, as
    the reference's); the towers
    (one client's tokens) and the baselines' per-client models do not. A
    rematerialised unit re-enters, in the backward, the group its forward
    saw (`models.stacks`)."""
    _ROUND_TOKENS.append(group)
    try:
        yield
    finally:
        _ROUND_TOKENS.pop()


def round_tokens_group():
    """The group of the innermost `round_tokens` block (None outside)."""
    return _ROUND_TOKENS[-1]


def moe_forward(p, x, cfg: ModelConfig, groups: Optional[int] = None):
    """x: [..., S, d] -> (y, aux_loss). Flattens leading dims into tokens.

    cfg.moe_groups > 1 splits the tokens into independent dispatch groups,
    each with its own capacity (aux is their mean), as the reference.
    `groups` overrides it: a decode over B slots whose rows are separate
    requests passes groups=B, so each token is dispatched alone, as the
    reference's continuous engine vmaps its tower decode over slots.
    Inside `round_tokens(group)` of D ranks, x is this rank's
    1/D of the round's tokens; the groups and capacity are those of all
    D blocks, and aux is this rank's share of the round's aux loss (the
    ranks' shares sum to it)."""
    orig_shape = x.shape
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    d = orig_shape[-1]
    ht = h.reshape(-1, d)  # [T, d]
    T = ht.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    g = _ROUND_TOKENS[-1] if groups is None else None
    if g is not None and g.size == 1:
        g = None
    total = T * (g.size if g is not None else 1)
    G = max(cfg.moe_groups, 1) if groups is None else groups
    if total % G != 0:
        G = 1
    Tg = total // G
    C = _capacity(Tg, E, k, cfg.capacity_factor)
    y, aux = _dispatch(p, ht, cfg, C, Tg, G, 0 if g is None else g.index * T, g)

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
