"""Plain float32 reference of the decoder LMs the benchmark runs: the
hybrid (Mamba2 layers with one shared attention + MLP block over the
residual stream applied every `shared_attn_every` layers: the program's
hybrid, not Zamba2's two alternating blocks over the concatenated stream,
arXiv:2411.15242) and the mixture of experts
(a dense lead layer, then attention + top-k routed and shared experts,
arXiv:2401.06066), split into client towers and a server stack.

Plain torch operations only: no kernel, cache or batching of the program,
and nothing imported from it. It reads its weights by canonical name
(`perfbench/lib/weights.py` makes them from the run's seed), and it
follows the program's published arithmetic: pre-norm residual blocks,
RMSNorm, rotary embeddings (the rotate-half form), SwiGLU, the chunked
SSD scan of Mamba2 with one group of B and C, a router in softmax with
renormalised top-k gates and a capacity of
max(8, ceil8(T k f / E + 1)) rows an expert, where the rows of an expert
beyond its capacity (in token-major order) are dropped, and the Switch
load-balance loss of every server MoE layer (a tower's is not trained).

`prec` selects the precision: "f32" (TF32 off); "fp8", the control,
which computes in float8 e4m3 (per-tensor scales) wherever the program
holds its bf16 compute dtype: both operands and the result of every
projection, the embedded tokens, the rotated queries and keys, the
conv's activated outputs and the scan's output, and the residual stream
after every block are rounded to it (norms, softmax and the scan's sums
stay in f32, as the program keeps them in f32); or "bf16", the same
roundings to bfloat16, which reads what the program's own compute dtype
alone does to the comparison. Each rounding is straight-through: the
backward runs in f32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    # a straight-through rounding: the backward sees the rounded product's
    # operands as the identity of the originals
    return x + (q - x).detach()


def _q16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


ROUND = {"fp8": _q8, "bf16": _q16}


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x rounded to the run's compute precision (the identity in f32)."""
    return ROUND[prec](x) if prec in ROUND else x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec in ROUND:
        r = ROUND[prec]
        return r(r(a) @ r(b))
    return a @ b


def layer_kinds(cfg: dict) -> list:
    out = []
    for i in range(cfg["num_layers"]):
        if cfg["family"] == "hybrid":
            every = cfg.get("shared_attn_every", 0)
            out.append("shared_attn" if every and (i + 1) % every == 0 else "mamba")
        elif cfg["family"] == "ssm":
            out.append("mamba")
        elif cfg["family"] == "moe":
            out.append("dense_lead" if i < cfg.get("first_dense_layers", 0) else "moe")
        else:
            raise ValueError(f"family {cfg['family']!r} has no reference here")
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta: float):
    """x [B, S, H, D]; pos [B, S] or [S] positions."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = pos.float()[..., None] * freqs
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Params, pre: str, x, cfg: dict, prec: str):
    """Causal self-attention over x [B, S, d] (+ rope at 0..S-1)."""
    B, S, d = x.shape
    H, Hkv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    h = rmsnorm(x, p[pre + "norm/scale"], cfg["norm_eps"])
    q = mm(h, p[pre + "wq"].reshape(d, H * D), prec).reshape(B, S, H, D)
    k = mm(h, p[pre + "wk"].reshape(d, Hkv * D), prec).reshape(B, S, Hkv, D)
    v = mm(h, p[pre + "wv"].reshape(d, Hkv * D), prec).reshape(B, S, Hkv, D)
    pos = torch.arange(S, device=x.device)
    q, k = (rnd(rope(t, pos, cfg["rope_theta"]), prec) for t in (q, k))
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H * D)
    return mm(out, p[pre + "wo"].reshape(H * D, d), prec)


def mlp(p: Params, pre: str, x, cfg: dict, prec: str):
    h = rmsnorm(x, p[pre + "norm/scale"], cfg["norm_eps"])
    return mm(F.silu(mm(h, p[pre + "wg"], prec)) * mm(h, p[pre + "wu"], prec),
              p[pre + "wd"], prec)


def _conv(x, w):
    """Depthwise causal conv of x [B, L, C] with taps w [W, C]."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """Mamba2's scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t
    by chunks: x [B, L, H, P], dt [B, L, H], A [H], Bm / Cm [B, L, N]; L a
    multiple of `chunk`. Returns y [B, L, H, P]."""
    Bsz, L, H, P = x.shape
    N, nc = Bm.shape[-1], L // chunk
    x = x.reshape(Bsz, nc, chunk, H, P)
    dt = dt.reshape(Bsz, nc, chunk, H)
    Bc, Cc = Bm.reshape(Bsz, nc, chunk, N), Cm.reshape(Bsz, nc, chunk, N)
    a = (dt * A).permute(0, 1, 3, 2)  # [B, nc, H, T]
    cum = a.cumsum(-1)
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))  # [B, nc, H, T, T]
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    w = cb[:, :, None] * decay * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = torch.einsum("bchts,bcshp->bcthp", w, x)
    to_end = torch.exp(cum[..., -1:] - cum)  # [B, nc, H, T]
    states = torch.einsum("bcht,bctn,bcthp->bchpn", to_end, Bc, x * dt[..., None])
    h = x.new_zeros(Bsz, H, P, N)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(cum[:, c, :, -1])[..., None, None] + states[:, c]
    entering = torch.stack(entering, 1)  # [B, nc, H, P, N]
    y = y + torch.einsum("bctn,bchpn,bcht->bcthp", Cc, entering, torch.exp(cum))
    return y.reshape(Bsz, L, H, P)


def mamba(p: Params, pre: str, x, cfg: dict, prec: str):
    B, L, d = x.shape
    d_in = cfg["ssm_expand"] * d
    P = cfg["ssm_headdim"]
    H = d_in // P
    eps = cfg["norm_eps"]
    h = rmsnorm(x, p[pre + "norm/scale"], eps)
    z, xr, Br, Cr, dt = (mm(h, p[pre + k], prec) for k in ("wz", "wx", "wB", "wC", "wdt"))
    xin, Bm, Cm = (rnd(F.silu(_conv(r, p[pre + k])), prec)
                   for r, k in ((xr, "conv_x"), (Br, "conv_B"), (Cr, "conv_C")))
    dt = torch.logaddexp(dt + p[pre + "dt_bias"], torch.zeros_like(dt))
    chunk = cfg["ssm_chunk"]
    pad = -L % chunk  # zero steps (dt = 0) leave the state as it is
    xh = F.pad(xin, (0, 0, 0, pad)).reshape(B, L + pad, H, P)
    y = ssd(xh, F.pad(dt, (0, 0, 0, pad)), -torch.exp(p[pre + "A_log"]),
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)), chunk)[:, :L]
    y = rnd(y + xin.reshape(B, L, H, P) * p[pre + "D"][:, None], prec)
    g = y.reshape(B, L, d_in) * F.silu(z)
    return mm(rmsnorm(g, p[pre + "gate_norm/scale"], eps), p[pre + "wo"], prec)


def capacity(T: int, E: int, k: int, factor: float) -> int:
    c = int((T * k * factor) / E) + 1
    return max(8, -(-c // 8) * 8)


def moe(p: Params, pre: str, x, cfg: dict, prec: str):
    """(y, the layer's load-balance loss) of x [B, S, d], all its tokens
    one dispatch group."""
    shape = x.shape
    d = shape[-1]
    E, k = cfg["num_experts"], cfg["experts_per_token"]
    h = rmsnorm(x, p[pre + "norm/scale"], cfg["norm_eps"]).reshape(-1, d)
    T = h.shape[0]
    probs = torch.softmax(h @ p[pre + "router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    C = capacity(T, E, k, cfg["capacity_factor"])
    flat = idx.reshape(-1)  # rows (token, choice), token-major
    y = torch.zeros_like(h)
    for e in range(E):
        rows = torch.nonzero(flat == e).reshape(-1)[:C]
        if rows.numel() == 0:
            continue
        tok = rows // k
        xe = h[tok]
        ye = mm(F.silu(mm(xe, p[pre + "wg"][e], prec)) * mm(xe, p[pre + "wu"][e], prec),
                p[pre + "wd"][e], prec)
        y = y.index_add(0, tok, ye * gates.reshape(-1)[rows][:, None])
    if cfg.get("num_shared_experts"):
        y = y + mm(F.silu(mm(h, p[pre + "shared/wg"], prec))
                   * mm(h, p[pre + "shared/wu"], prec), p[pre + "shared/wd"], prec)
    routed = torch.bincount(flat, minlength=E).float() / T
    aux = E * (probs.mean(0) * routed).sum()
    return y.reshape(shape), aux


def layer_fn(p: Params, side: str, i: int, kind: str, cfg: dict, prec: str,
             m: Optional[int] = None) -> Callable:
    """The residual function x -> (x, aux) of layer i of `side`'s stack
    ("towers" with client m, or "server")."""
    pre = f"{side}/layers/{i}/"
    shared = f"{side}/shared/"
    if m is not None:
        p = {k[len(pre):]: v[m] for k, v in p.items() if k.startswith(pre)} | \
            {"shared/" + k[len(shared):]: v[m] for k, v in p.items()
             if k.startswith(shared)}
        pre, shared = "", "shared/"

    def f(x):
        aux = x.new_zeros(())
        if kind == "shared_attn":
            x = x + attention(p, shared + "attn/", x, cfg, prec)
            x = x + mlp(p, shared + "mlp/", x, cfg, prec)
        if kind in ("mamba", "shared_attn"):
            x = x + mamba(p, pre + "mamba/", x, cfg, prec)
        elif kind == "dense_lead":
            x = x + attention(p, pre + "attn/", x, cfg, prec)
            x = x + mlp(p, pre + "mlp/", x, cfg, prec)
        elif kind == "moe":
            x = x + attention(p, pre + "attn/", x, cfg, prec)
            y, aux = moe(p, pre + "moe/", x, cfg, prec)
            x = x + y
        return rnd(x, prec), aux

    return f


def _run(f, x, remat: bool):
    if remat and torch.is_grad_enabled():
        return checkpoint(f, x, use_reentrant=False)
    return f(x)


def tower(p: Params, m: int, tokens, cfg: dict, prec: str, remat: bool = True):
    """Client m's tower over tokens [b, S]: the smashed data [b, S, d]."""
    kinds = layer_kinds(cfg)[:cfg["split_layers"]]
    x = rnd(p["towers/embed/table"][m][tokens] * math.sqrt(cfg["d_model"]), prec)
    for i, kind in enumerate(kinds):
        x, _ = _run(layer_fn(p, "towers", i, kind, cfg, prec, m), x, remat)
    return x


def server(p: Params, h, cfg: dict, prec: str, remat: bool = True):
    """The server stack over h [B, S, d]: (logits [B, S, V], the weighted
    load-balance loss of its MoE layers)."""
    kinds = layer_kinds(cfg)[cfg["split_layers"]:]
    aux = h.new_zeros(())
    for j, kind in enumerate(kinds):
        h, a = _run(layer_fn(p, "server", j, kind, cfg, prec), h, remat)
        aux = aux + a * cfg.get("router_aux_weight", 0.0)
    h = rmsnorm(h, p["server/norm/scale"], cfg["norm_eps"])
    return mm(h, p["server/head/w"], prec), aux


def round_loss(p: Params, tokens, cfg: dict, prec: str = "f32", remat: bool = True,
               half: bool = False):
    """The mtsl objective of one round batch tokens [M, b, S]: the sum over
    clients of each one's mean next-token cross-entropy, plus the server's
    load-balance loss. `half` is a planted fault: each client's mean is
    taken over the first half of its sequences' positions only."""
    M, b, S = tokens.shape
    h = torch.cat([tower(p, m, tokens[m], cfg, prec, remat) for m in range(M)])
    logits, aux = server(p, h, cfg, prec, remat)
    logits = logits.reshape(M, b, S, -1)[:, :, :-1]
    labels = tokens[:, :, 1:].long()
    if half:
        logits, labels = logits[:, :, :(S - 1) // 2], labels[:, :, :(S - 1) // 2]
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    return nll.reshape(M, -1).mean(-1).sum() + aux

