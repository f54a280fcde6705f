"""Mamba2 (SSD) block (port of `repro.models.ssm`, lines 19-107, the
training forward): projections + causal depthwise conv + chunked SSD scan
+ gated RMSNorm + output projection.

The scan always goes through the SSD-scan wrapper (K3): the CUDA kernel on
CUDA tensors, the plain chunked oracle on CPU tensors. The reference
reaches its Pallas kernel only under cfg.use_flash_kernel (off by
default); the port does not read the flag, so that the kernel is the path
(both compute one function). The serving paths (prefill, decode, extend
with their conv and SSM caches) are not ported.

Parameters: a training tree, every leaf in cfg.param_dtype (`A_log`, `D`
and `dt_bias` always f32), each matmul and conv weight cast to cfg.dtype
at its use, as the reference casts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import compute_dtype, param_dtype, rmsnorm, rmsnorm_params
from repro_torch.nn import param


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return d_in, nheads, cfg.ssm_state, cfg.ssm_conv_width


def mamba_params(gen, cfg: ModelConfig):
    d = cfg.d_model
    d_in, H, N, W = _dims(cfg)
    dt = param_dtype(cfg)
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
        "gate_norm": {"scale": param(gen, (d_in,), init="ones", dtype=dt)},
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


def mamba_forward(p, x, cfg: ModelConfig):
    """x: [B,L,d] -> y [B,L,d]."""
    cdt = compute_dtype(cfg)
    d_in, H, N, W = _dims(cfg)
    P = cfg.ssm_headdim
    B_, L, _ = x.shape
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    z = h @ p["wz"].to(cdt)
    xin = h @ p["wx"].to(cdt)
    Bm = h @ p["wB"].to(cdt)
    Cm = h @ p["wC"].to(cdt)
    dt_ = h @ p["wdt"].to(cdt)

    xin = F.silu(_causal_conv(xin, p["conv_x"].to(cdt)))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"].to(cdt)))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"].to(cdt)))
    dt_ = softplus(dt_.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])  # negative decays

    xh = xin.reshape(B_, L, H, P)
    # pad L to a chunk multiple
    chunk = cfg.ssm_chunk
    padl = -(-L // chunk) * chunk - L
    if padl:
        xh = F.pad(xh, (0, 0, 0, 0, 0, padl))
        dt_ = F.pad(dt_, (0, 0, 0, padl))
        Bm = F.pad(Bm, (0, 0, 0, padl))
        Cm = F.pad(Cm, (0, 0, 0, padl))
    y, _ = ssd_scan(xh, dt_, A, Bm, Cm, chunk=chunk)
    y = y[:, :L]
    y = y + xin.reshape(B_, L, H, P) * p["D"][None, None, :, None].to(cdt)
    y = y.reshape(B_, L, d_in)
    y = _gated_norm(p["gate_norm"], y, z, cfg.norm_eps)
    return y @ p["wo"].to(cdt)
