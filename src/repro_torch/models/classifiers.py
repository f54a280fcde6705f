"""Paper-scale classifiers (port of `repro.models.classifiers`): the 4-layer
MLP (MNIST-likes) and the CIFAR ResNet-16, built pre-split as the paper
splits them:

  MLP:    split_layers dense layers client-side, the rest server-side (2/2).
  ResNet: stem + split_layers stages client-side (9 conv layers for the
          default (16,2)(32,2)(64,2) stages, split=2), the rest + head on
          the server.

Plain functions on parameter trees with the reference's keys and layouts:
dense `w[din, dout]` applied as `x @ w + b`, conv weights `HWIO`, NHWC
activations at every interface (the smashed `{"h": ...}` included). Each
conv permutes to NCHW for PyTorch internally and back.

Two details must match XLA exactly: `SAME` padding is XLA's rule, which is
asymmetric under stride 2 (`same_padding`), and the block norm is an
affine-free LayerNorm over the channel axis (biased variance, eps 1e-5),
not a BatchNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import param


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _dense(gen, din, dout, dtype):
    return {"w": param(gen, (din, dout), dtype=dtype),
            "b": param(gen, (dout,), init="zeros", dtype=dtype)}


def _dense_apply(p, x):
    return x @ p["w"] + p["b"]


def mlp_model(cfg: ModelConfig):
    from repro_torch.models.registry import Model

    dims = cfg.mlp_dims
    split = cfg.split_layers
    if not 0 < split < len(dims) - 1:
        raise ValueError(f"split_layers={split} must be in (0, {len(dims) - 1})")
    dt = getattr(torch, cfg.param_dtype)
    n_server = len(dims) - 1 - split

    def init_tower(gen):
        return {f"fc{i}": _dense(gen, dims[i], dims[i + 1], dt)
                for i in range(split)}

    def init_server(gen):
        return {f"fc{i}": _dense(gen, dims[split + i], dims[split + i + 1], dt)
                for i in range(n_server)}

    def tower_forward(tp, inputs):
        x = inputs["image"].reshape(inputs["image"].shape[0], -1)
        for i in range(split):
            x = F.relu(_dense_apply(tp[f"fc{i}"], x))
        return {"h": x}

    def server_forward(sp, smashed):
        x = smashed["h"]
        for i in range(n_server):
            x = _dense_apply(sp[f"fc{i}"], x)
            if i < n_server - 1:
                x = F.relu(x)
        return x, _zero_aux(x)

    return Model(cfg=cfg, init_tower=init_tower, init_server=init_server,
                 tower_forward=tower_forward, server_forward=server_forward)


# ---------------------------------------------------------------------------
# ResNet (CIFAR-style, post-activation basic blocks, affine-free LayerNorm
# in place of BatchNorm so the math is batch-independent)
# ---------------------------------------------------------------------------


def same_padding(n: int, k: int, s: int) -> tuple:
    """XLA's `SAME` padding of one spatial dim of size n for kernel k and
    stride s: (before, after). The output has ceil(n / s) positions and
    the odd pixel goes AFTER, so a 3x3 stride-2 conv of an even size pads
    (0, 1), where PyTorch's `padding=1` would pad (1, 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(gen, cin, cout, k, dtype):
    return {"w": param(gen, (k, k, cin, cout), dtype=dtype, fan_in=k * k * cin)}


def _conv_apply(p, x, stride=1):
    """NHWC x, HWIO w -> NHWC, with XLA `SAME` padding."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    if kh == kw == 1:
        # a 1x1 conv never pads and reads every stride-th pixel: a matmul
        # over channels. (As a strided conv on the CPU, oneDNN's backward
        # corrupts the heap at some batch sizes, torch 2.13.)
        return x[:, ::stride, ::stride, :] @ w[0, 0]
    ph = same_padding(x.shape[1], kh, stride)
    pw = same_padding(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _ln(x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def _basic_block_params(gen, cin, cout, dtype):
    p = {"conv1": _conv(gen, cin, cout, 3, dtype),
         "conv2": _conv(gen, cout, cout, 3, dtype)}
    if cin != cout:
        p["proj"] = _conv(gen, cin, cout, 1, dtype)
    return p


def _basic_block_apply(p, x, stride):
    h = F.relu(_ln(_conv_apply(p["conv1"], x, stride)))
    h = _ln(_conv_apply(p["conv2"], h, 1))
    sc = _conv_apply(p["proj"], x, stride) if "proj" in p else x
    return F.relu(h + sc)


def resnet_model(cfg: ModelConfig):
    from repro_torch.models.registry import Model

    stages = cfg.resnet_stages
    split = cfg.split_layers
    if not 0 < split <= len(stages):
        raise ValueError(f"split_layers={split} must be in (0, {len(stages)}]")
    dt = getattr(torch, cfg.param_dtype)

    def _stage_init(gen, cin, cout, nblocks):
        return {f"b{i}": _basic_block_params(gen, cin if i == 0 else cout, cout, dt)
                for i in range(nblocks)}

    def _stage_apply(p, x, nblocks, first_stride):
        for i in range(nblocks):
            x = _basic_block_apply(p[f"b{i}"], x, first_stride if i == 0 else 1)
        return x

    def init_tower(gen):
        p = {"stem": _conv(gen, cfg.image_channels, stages[0][0], 3, dt)}
        cin = stages[0][0]
        for s in range(split):
            cout, nb = stages[s]
            p[f"stage{s}"] = _stage_init(gen, cin, cout, nb)
            cin = cout
        return p

    def init_server(gen):
        p = {}
        cin = stages[split - 1][0]
        for s in range(split, len(stages)):
            cout, nb = stages[s]
            p[f"stage{s}"] = _stage_init(gen, cin, cout, nb)
            cin = cout
        p["head"] = _dense(gen, cin, cfg.num_classes, dt)
        return p

    def tower_forward(tp, inputs):
        x = inputs["image"]
        if x.ndim == 3:
            x = x[..., None]
        x = F.relu(_ln(_conv_apply(tp["stem"], x, 1)))
        for s in range(split):
            x = _stage_apply(tp[f"stage{s}"], x, stages[s][1],
                             first_stride=1 if s == 0 else 2)
        return {"h": x}

    def server_forward(sp, smashed):
        x = smashed["h"]
        for s in range(split, len(stages)):
            x = _stage_apply(sp[f"stage{s}"], x, stages[s][1],
                             first_stride=1 if s == 0 else 2)
        x = x.mean(dim=(1, 2))  # global average pool over (H, W)
        return _dense_apply(sp["head"], x), _zero_aux(x)

    return Model(cfg=cfg, init_tower=init_tower, init_server=init_server,
                 tower_forward=tower_forward, server_forward=server_forward)
