"""The weights of a run, made on the device from `--seed`, and the names
they go by.

Every leaf has a canonical name: `towers/embed/table`,
`towers/layers/<i>/<block>/<key>`, `server/layers/<j>/...`,
`server/shared/...` (the hybrid's shared block), `server/norm/scale`,
`server/head/w`; a tower leaf carries the client axis first. The
reference (`perfbench/reference`) lists the leaves from the
configuration alone (`specs`); the program's parameter tree is read
under the same names (`port_leaves`), and the two lists must agree.

Values: a matrix N(0, 1) / sqrt(fan in), the embedding table 0.02 N(0, 1),
norm scales and Mamba's D one, A_log and dt_bias zero. The normal draws
come from one stream in chunks of CHUNK elements, chunk k from a
generator on the device seeded by (seed, k), laid over the random leaves
in the order of their names; so any leaf can be drawn again alone
(`initial_leaves`), which is how the first and third steps' changes are
measured without a second copy of the model on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

CHUNK = 1 << 28
CONSTANTS = {"scale": 1.0, "D": 1.0, "A_log": 0.0, "dt_bias": 0.0}


class Spec(NamedTuple):
    name: str
    shape: Tuple[int, ...]


def _block_specs(kind: str, cfg: dict) -> List[Tuple[str, tuple]]:
    d = cfg["d_model"]
    H, Hkv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]

    def attn(pre):
        return [(pre + "wq", (d, H, D)), (pre + "wk", (d, Hkv, D)),
                (pre + "wv", (d, Hkv, D)), (pre + "wo", (H, D, d)),
                (pre + "norm/scale", (d,))]

    def mlp(pre, f):
        return [(pre + "wg", (d, f)), (pre + "wu", (d, f)),
                (pre + "wd", (f, d)), (pre + "norm/scale", (d,))]

    if kind in ("mamba", "shared_attn"):
        d_in = cfg["ssm_expand"] * d
        Hs, N, W = d_in // cfg["ssm_headdim"], cfg["ssm_state"], cfg["ssm_conv_width"]
        pre = "mamba/"
        return [(pre + "norm/scale", (d,)), (pre + "wz", (d, d_in)),
                (pre + "wx", (d, d_in)), (pre + "wB", (d, N)),
                (pre + "wC", (d, N)), (pre + "wdt", (d, Hs)),
                (pre + "conv_x", (W, d_in)), (pre + "conv_B", (W, N)),
                (pre + "conv_C", (W, N)), (pre + "A_log", (Hs,)),
                (pre + "D", (Hs,)), (pre + "dt_bias", (Hs,)),
                (pre + "gate_norm/scale", (d_in,)), (pre + "wo", (d_in, d))]
    if kind == "dense_lead":
        return attn("attn/") + mlp("mlp/", cfg["d_ff"])
    if kind == "moe":
        E, f = cfg["num_experts"], cfg["moe_d_ff"]
        out = attn("attn/") + [
            ("moe/router", (d, E)), ("moe/wg", (E, d, f)),
            ("moe/wu", (E, d, f)), ("moe/wd", (E, f, d)),
            ("moe/norm/scale", (d,))]
        if cfg.get("num_shared_experts"):
            fs = f * cfg["num_shared_experts"]
            out += [("moe/shared/wg", (d, fs)), ("moe/shared/wu", (d, fs)),
                    ("moe/shared/wd", (fs, d))]
        return out
    raise ValueError(f"unknown layer kind {kind!r}")


def specs(cfg: dict, num_clients: int) -> List[Spec]:
    """Every leaf of the model split at cfg["split_layers"] with
    `num_clients` towers, sorted by name."""
    from perfbench.reference.model import layer_kinds

    d, V, M = cfg["d_model"], cfg["vocab_size"], num_clients
    kinds = layer_kinds(cfg)
    split = cfg["split_layers"]
    out = [Spec("towers/embed/table", (M, V, d))]
    for side, ks, lead in (("towers", kinds[:split], (M,)), ("server", kinds[split:], ())):
        for i, kind in enumerate(ks):
            out += [Spec(f"{side}/layers/{i}/{n}", lead + s)
                    for n, s in _block_specs(kind, cfg)]
        if "shared_attn" in ks:
            out += [Spec(f"{side}/shared/{n}", lead + s)
                    for n, s in _block_specs("dense_lead", cfg)]
    out += [Spec("server/norm/scale", (d,)), Spec("server/head/w", (d, V))]
    return sorted(out)


def _init(name: str, shape: tuple) -> Tuple[str, float]:
    """("const", value) or ("normal", std) for a leaf (shape without the
    client axis)."""
    key = name.rsplit("/", 1)[-1]
    if key in CONSTANTS:
        return "const", CONSTANTS[key]
    if key == "table":
        return "normal", 0.02
    if "/attn/" in name and key in ("wq", "wk", "wv"):
        fan_in = shape[-3]
    elif "/attn/" in name and key == "wo":
        fan_in = shape[-3] * shape[-2]
    else:
        fan_in = shape[-2]
    return "normal", 1.0 / math.sqrt(fan_in)


def _plan(spec: List[Spec]):
    """[(spec, kind, value, offset in the stream)] and the stream's length."""
    out, off = [], 0
    for s in spec:
        shape = s.shape[1:] if s.name.startswith("towers/") else s.shape
        kind, val = _init(s.name, shape)
        out.append((s, kind, val, off if kind == "normal" else -1))
        if kind == "normal":
            off += math.prod(s.shape)
    return out, off


def _chunk(seed: int, k: int, n: int, device) -> torch.Tensor:
    s = int(np.random.SeedSequence([int(seed), k]).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return torch.randn(n, generator=gen, device=device)


def fill_(targets: Dict[str, torch.Tensor], spec: List[Spec], seed: int) -> None:
    """Write every leaf's initial values into targets[name] (contiguous
    tensors of any float dtype, on one device), in a few large draws."""
    plan, total = _plan(spec)
    device = next(iter(targets.values())).device
    for s, kind, val, _ in plan:
        if kind == "const":
            targets[s.name].fill_(val)
    rand = [(s, val, off) for s, kind, val, off in plan if kind == "normal"]
    i = 0
    for k in range(-(-total // CHUNK)):
        lo, hi = k * CHUNK, min((k + 1) * CHUNK, total)
        z = _chunk(seed, k, hi - lo, device)
        while i < len(rand):
            s, std, off = rand[i]
            n = math.prod(s.shape)
            a, b = max(off, lo), min(off + n, hi)
            if a < b:
                dst = targets[s.name].view(-1)[a - off:b - off]
                dst.copy_(z[a - lo:b - lo].mul_(std))
            if off + n > hi:
                break
            i += 1
        del z


def initial_leaves(spec: List[Spec], seed: int,
                   device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, initial value in f32) of every leaf in `spec` order, drawn
    again from the seed."""
    plan, total = _plan(spec)
    cache = {"k": -1, "z": None}

    def piece(a, b):
        parts = []
        while a < b:
            k = a // CHUNK
            if cache["k"] != k:
                cache["z"] = None
                cache["k"], cache["z"] = k, _chunk(seed, k, min(CHUNK, total - k * CHUNK),
                                                   device)
            e = min(b, (k + 1) * CHUNK)
            parts.append(cache["z"][a - k * CHUNK:e - k * CHUNK])
            a = e
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    for s, kind, val, off in plan:
        if kind == "const":
            x = torch.full(s.shape, val, dtype=torch.float32, device=device)
        else:
            x = (piece(off, off + math.prod(s.shape)) * val).reshape(s.shape)
        yield s.name, x


def make_params(spec: List[Spec], seed: int, device,
                requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's weights: {name: f32 leaf}."""
    out = {s.name: torch.empty(s.shape, dtype=torch.float32, device=device)
           for s in spec}
    fill_(out, spec, seed)
    for x in out.values():
        x.requires_grad_(requires_grad)
    return out


def _layers(blocks) -> list:
    """The per-layer trees of a stack in layer order: seg0's units, then
    seg1's, ...; in each unit its blocks "0", "1", ..."""
    out = []
    segs = sorted((k for k in blocks if k.startswith("seg")), key=lambda k: int(k[3:]))
    for key in segs:
        t = blocks[key]
        for unit in (t if isinstance(t, list) else [t]):
            out += [unit[b] for b in sorted(unit, key=int)]
    return out


def _flat(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = tree


def port_leaves(params: dict) -> Dict[str, torch.Tensor]:
    """{canonical name: leaf} of the program's parameter tree
    {"towers": {"embed", "blocks"}, "server": {"blocks", "norm", "head"}}."""
    out: Dict[str, torch.Tensor] = {}
    for side in ("towers", "server"):
        tree = params[side]
        for key, sub in tree.items():
            if key != "blocks":
                _flat(sub, f"{side}/{key}", out)
                continue
            if "shared" in sub:
                _flat(sub["shared"], f"{side}/shared", out)
            for i, layer in enumerate(_layers(sub)):
                _flat(layer, f"{side}/layers/{i}", out)
    return out


def check_same(spec: List[Spec], leaves: Dict[str, torch.Tensor]) -> None:
    """Raise unless the program's leaves are the reference's, by name and
    shape."""
    want = {s.name: tuple(s.shape) for s in spec}
    got = {k: tuple(v.shape) for k, v in leaves.items()}
    if want != got:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])[:5]
        raise ValueError(f"the program's parameters are not the reference's: "
                         f"missing {missing}, extra {extra}, shapes differ {wrong}")
