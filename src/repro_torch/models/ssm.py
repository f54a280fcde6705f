"""Mamba2 (SSD) block (port of `repro.models.ssm`): projections + causal
depthwise conv + chunked SSD scan + gated RMSNorm + output projection,
with the serving paths that keep a decode cache per row: the raw
(pre-conv, pre-silu) tails of the x, B and C projections, [B, W-1, D] in
cfg.dtype, and the SSM state, [B, H, P, N] in f32.

  forward  the training forward over a whole sequence (optionally from an
           initial state, optionally returning the final one)
  prefill  forward + the cache built from the sequence's tail
  extend   a fixed-size chunk of C tokens per row resumed from the cache,
           with n_valid real tokens per row (chunked prefill)
  decode   one token per row, the O(1) recurrence

Every scan (forward, prefill, extend) goes through the SSD-scan wrapper
(K3): the CUDA kernel on CUDA tensors, the plain chunked oracle on CPU
tensors. The reference reaches its Pallas kernel only under
cfg.use_flash_kernel (off by default), and its extend never; the port
does not read the flag, so that the kernel is the path (both compute one
function). Decode is the one-token recurrence (`ssd_decode_step`), which
no TPU kernel computes.

Extend and decode write the cache IN PLACE (`copy_` into the tensors they
are given, which may be views of an engine's slot pool); the reference
returns a new cache. Decode takes an optional per-row `write` mask: rows
where it is False keep their cache, as attention's decode does.

Parameters: a training tree (`serving=False`), every leaf in
cfg.param_dtype, each matmul and conv weight cast to cfg.dtype at its use,
as the reference casts; or a serving tree (`serving=True`) with those
weights stored in cfg.dtype. `A_log`, `D`, `dt_bias` and the norm scales
stay f32 in both.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode.ref import per_row
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step
from repro_torch.models.layers import (
    compute_dtype,
    param_dtype,
    rmsnorm,
    rmsnorm_params,
    weight_dtype,
)
from repro_torch.nn import param


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return d_in, nheads, cfg.ssm_state, cfg.ssm_conv_width


def mamba_params(gen, cfg: ModelConfig, serving: bool = False):
    d = cfg.d_model
    d_in, H, N, W = _dims(cfg)
    dt = weight_dtype(cfg, serving)
    f32 = torch.float32
    return {
        "norm": rmsnorm_params(gen, d),
        "wz": param(gen, (d, d_in), dtype=dt),
        "wx": param(gen, (d, d_in), dtype=dt),
        "wB": param(gen, (d, N), dtype=dt),
        "wC": param(gen, (d, N), dtype=dt),
        "wdt": param(gen, (d, H), dtype=dt),
        "conv_x": param(gen, (W, d_in), dtype=dt, fan_in=W),
        "conv_B": param(gen, (W, N), dtype=dt, fan_in=W),
        "conv_C": param(gen, (W, N), dtype=dt, fan_in=W),
        "A_log": param(gen, (H,), init="zeros", dtype=f32),
        "D": param(gen, (H,), init="ones", dtype=f32),
        "dt_bias": param(gen, (H,), init="zeros", dtype=f32),
        "gate_norm": {"scale": param(gen, (d_in,), init="ones",
                                     dtype=param_dtype(cfg))},
        "wo": param(gen, (d_in, d), dtype=dt),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: [B,L,D]; w: [W,D]. The taps are summed in
    the reference's order (0 + tap 0 + tap 1 + ...)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :] for i in range(W))


def _gated_norm(p, y, z, eps):
    """RMSNorm(y * silu(z)), Mamba2's gated output norm."""
    gf = (y * F.silu(z)).float()
    var = gf.square().mean(dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * p["scale"].float()).to(y.dtype)


def softplus(x):
    """log(1 + exp(x)) as jax.nn.softplus computes it, logaddexp(x, 0)
    (torch's F.softplus switches to x above a threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p, x, cfg: ModelConfig):
    """The block's input projections of x [..., d]: (z, x, B, C, dt), each
    in cfg.dtype, before the conv."""
    cdt = compute_dtype(cfg)
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    return tuple(h @ p[k].to(cdt) for k in ("wz", "wx", "wB", "wC", "wdt"))


def _scan(p, xin, Bm, Cm, dt_, cfg: ModelConfig, initial_state=None):
    """The SSD scan of L steps (the activated conv outputs xin [B,L,d_in],
    Bm / Cm [B,L,N] and dt_ [B,L,H] f32), padded with zeros up to a
    multiple of cfg.ssm_chunk, as the reference pads it (a zero step has
    dt = 0, so it leaves the state unchanged). Returns (y [B,L,H,P], the
    final state f32)."""
    d_in, H, N, W = _dims(cfg)
    B_, L, _ = xin.shape
    xh = xin.reshape(B_, L, H, cfg.ssm_headdim)
    chunk = cfg.ssm_chunk
    padl = -(-L // chunk) * chunk - L
    if padl:
        xh = F.pad(xh, (0, 0, 0, 0, 0, padl))
        dt_ = F.pad(dt_, (0, 0, 0, padl))
        Bm = F.pad(Bm, (0, 0, 0, padl))
        Cm = F.pad(Cm, (0, 0, 0, padl))
    A = -torch.exp(p["A_log"])  # negative decays
    y, state = ssd_scan(xh, dt_, A, Bm, Cm, chunk=chunk,
                        initial_state=initial_state)
    return y[:, :L], state


def _output(p, y, xin, z, cfg: ModelConfig):
    """y [B,L,H,P] + D skip -> gated norm -> output projection [B,L,d]."""
    cdt = compute_dtype(cfg)
    B_, L, d_in = xin.shape
    y = y + xin.reshape(y.shape) * p["D"][None, None, :, None].to(cdt)
    y = _gated_norm(p["gate_norm"], y.reshape(B_, L, d_in), z, cfg.norm_eps)
    return y @ p["wo"].to(cdt)


def _forward(p, x, cfg: ModelConfig, initial_state=None):
    """The block over x [B,L,d]: (y [B,L,d], the final SSM state, the raw
    x / B / C projections before the conv)."""
    cdt = compute_dtype(cfg)
    z, x_raw, B_raw, C_raw, dt_ = _project(p, x, cfg)
    xin = F.silu(_causal_conv(x_raw, p["conv_x"].to(cdt)))
    Bm = F.silu(_causal_conv(B_raw, p["conv_B"].to(cdt)))
    Cm = F.silu(_causal_conv(C_raw, p["conv_C"].to(cdt)))
    dt_ = softplus(dt_.float() + p["dt_bias"][None, None, :])
    y, state = _scan(p, xin, Bm, Cm, dt_, cfg, initial_state)
    return _output(p, y, xin, z, cfg), state, (x_raw, B_raw, C_raw)


def mamba_forward(p, x, cfg: ModelConfig, *, return_state: bool = False,
                  initial_state: Optional[torch.Tensor] = None):
    """x: [B,L,d] -> y [B,L,d] (and the final SSM state [B,H,P,N] f32 with
    return_state), the scan resumed from `initial_state` when given."""
    out, state, _ = _forward(p, x, cfg, initial_state)
    return (out, state) if return_state else out


def init_mamba_cache(cfg: ModelConfig, batch: int, device):
    """A zeroed decode cache for `batch` rows (see the module docstring)."""
    d_in, H, N, W = _dims(cfg)
    cdt = compute_dtype(cfg)

    def z(*shape, dtype=cdt):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return {"conv_x": z(W - 1, d_in), "conv_B": z(W - 1, N),
            "conv_C": z(W - 1, N),
            "state": z(H, cfg.ssm_headdim, N, dtype=torch.float32)}


def _tail(raw, W: int):
    """The last W-1 raw steps of raw [B,L,D], zero-filled on the left when
    L < W-1 (the causal conv's zero history)."""
    if raw.shape[1] < W - 1:
        raw = F.pad(raw, (0, 0, W - 1 - raw.shape[1], 0))
    return raw[:, raw.shape[1] - (W - 1):].clone()  # not a view of raw


def mamba_prefill(p, x, cfg: ModelConfig):
    """Forward over x [B,L,d] and the decode cache built from its tail.
    Returns (y [B,L,d], cache)."""
    out, state, raw = _forward(p, x, cfg)
    W = cfg.ssm_conv_width
    cache = {k: _tail(r, W) for k, r in zip(("conv_x", "conv_B", "conv_C"), raw)}
    return out, dict(cache, state=state)


def _conv_extend(hist, new, w, n_valid):
    """The causal conv of a chunk new [B,C,D] after the raw history hist
    [B,W-1,D]: position t sees [t, t+W) of their concatenation, with the
    taps summed in _causal_conv's order. Also returns the new raw tail,
    the W-1 steps that end at each row's n_valid-th token (an int, or an
    int32 [B] tensor)."""
    W, C = w.shape[0], new.shape[1]
    full = torch.cat([hist.to(new.dtype), new], dim=1)
    y = sum(full[:, i: i + C, :] * w[i][None, None, :] for i in range(W))
    if not torch.is_tensor(n_valid):
        return y, full[:, n_valid: n_valid + W - 1]
    idx = n_valid.long()[:, None] + torch.arange(W - 1, device=new.device)
    rows = torch.arange(new.shape[0], device=new.device)[:, None]
    return y, full[rows, idx]


def mamba_extend(p, x_c, cache, n_valid, cfg: ModelConfig):
    """Chunked-prefill continuation: a chunk x_c [B,C,d] resumed from the
    decode cache, which is updated in place. n_valid: an int or [B] real
    (non-padding) tokens per row, 1 <= n_valid <= C.

    Padded steps get dt = 0 *after* softplus, so their update is an exact
    identity (decay exp(0) = 1, no B injection) and the final state equals
    a scan over the real rows only. The chunk is padded up to a multiple of
    cfg.ssm_chunk before the scan (K3 needs L % chunk == 0). The conv tails
    are the raw steps that end at each row's n_valid. Returns y [B,C,d];
    outputs at padded positions are garbage for the caller to ignore."""
    cdt = compute_dtype(cfg)
    B_, C, _ = x_c.shape
    if torch.is_tensor(n_valid):
        n_valid = per_row(n_valid, B_, x_c.device)
    z, xin, Bm, Cm, dt_ = _project(p, x_c, cfg)
    xin, conv_x = _conv_extend(cache["conv_x"], xin, p["conv_x"].to(cdt), n_valid)
    Bm, conv_B = _conv_extend(cache["conv_B"], Bm, p["conv_B"].to(cdt), n_valid)
    Cm, conv_C = _conv_extend(cache["conv_C"], Cm, p["conv_C"].to(cdt), n_valid)
    xin, Bm, Cm = F.silu(xin), F.silu(Bm), F.silu(Cm)
    dt_ = softplus(dt_.float() + p["dt_bias"][None, None, :])
    steps = torch.arange(C, device=x_c.device)
    valid = (steps[None, :] < (n_valid[:, None] if torch.is_tensor(n_valid)
                               else n_valid))[:, :, None]
    dt_ = torch.where(valid, dt_, torch.zeros_like(dt_))
    y, state = _scan(p, xin, Bm, Cm, dt_, cfg, cache["state"])
    out = _output(p, y, xin, z, cfg)
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B),
                     ("conv_C", conv_C), ("state", state)):
        cache[key].copy_(new)
    return out


def mamba_decode(p, x_t, cache, cfg: ModelConfig,
                 write: Optional[torch.Tensor] = None):
    """One-token decode. x_t: [B,1,d]. The conv tails shift by one and the
    state takes one recurrence step, in place, on the rows where `write`
    ([B] bool; all rows when None) is True; the other rows keep their
    cache (an engine's frozen slots, another client's rows). Returns
    y [B,1,d]."""
    cdt = compute_dtype(cfg)
    d_in, H, N, W = _dims(cfg)
    z, xin, Bm, Cm, dt_ = _project(p, x_t[:, 0], cfg)  # [B, ...]

    def conv_step(hist, new, w):
        # the reference's einsum("bwd,wd->bd"): three launches, not a
        # product and a sum per tap (decode is host-bound)
        full = torch.cat([hist, new[:, None, :]], dim=1)  # [B, W, D]
        return (full * w[None]).sum(dim=1), full[:, 1:]

    xin, conv_x = conv_step(cache["conv_x"], xin, p["conv_x"].to(cdt))
    Bm, conv_B = conv_step(cache["conv_B"], Bm, p["conv_B"].to(cdt))
    Cm, conv_C = conv_step(cache["conv_C"], Cm, p["conv_C"].to(cdt))
    xin, Bm, Cm = F.silu(xin), F.silu(Bm), F.silu(Cm)
    dt_ = softplus(dt_.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(-1, H, cfg.ssm_headdim)
    y, state = ssd_decode_step(cache["state"], xh, dt_, A, Bm, Cm)
    y = y + xh * p["D"][None, :, None].to(cdt)
    y = _gated_norm(p["gate_norm"], y.reshape(-1, d_in), z, cfg.norm_eps)
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B),
                     ("conv_C", conv_C), ("state", state)):
        old = cache[key]
        if write is not None:
            new = torch.where(write.reshape((-1,) + (1,) * (old.ndim - 1)),
                              new, old)
        old.copy_(new)
    return (y @ p["wo"].to(cdt))[:, None, :]
