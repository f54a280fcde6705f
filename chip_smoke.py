#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (`src/repro_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  build   nvcc builds every kernel of the ported paths from the sources in
          this checkout, all at once (K4 flash-decode and K1 mtsl_update,
          for sm_90a), and prints each ptxas report.
  kernel  K4 against its plain PyTorch version on the card at the serving
          path's shapes (4 slots, cap 320) and at 8 rows with ragged
          kv_valid, cap in {512, 4096}, window in {0, 1024}: bf16 within
          2e-2, one f32 case within 2e-5. Times the kernel, the plain
          version, F.scaled_dot_product_attention with the same mask (a
          yardstick only: the port never calls it) and the bound (bytes
          over 3.35 TB/s or flops over the dtype's peak, whichever is
          larger), each launch behind an L2 flush.
  k1      K1 against its plain version: every leaf shape that the train
          phase updates, read from the initial trees of full
          paper-resnet16 and paper-mlp with M = 10 (towers with one step
          size per client, the server with one), a flat 2^26-element leaf
          in f32 and bf16 (scalar step), and an odd 2003-element leaf (the
          scalar tail). Each must be bit-equal.
          Times the kernel, the plain version and one PyTorch call of the
          same function (`add_` / `addcmul_`, a yardstick only), each
          behind an L2 flush; the bound is 3 * numel * itemsize bytes over
          3.35 TB/s.
  slice   gemma3-12b at full width and full depth (48 layers), M = 2
          clients, random weights from a seed, served through
          `repro_torch.launch.serve` (continuous engine, --bench): 8
          requests alternating clients, prompts of 64..256 tokens, 32 new
          tokens each, 4 slots, chunk 64. Checks every request's tokens,
          finite logits, and that every decode attention launched K4:
          launches == attn_decode calls == (6 M + 42) per decode step, and
          the plain decode ran 0 times on the card.
  parity  full width, one 6-layer pattern unit in the tower and one in the
          server, f32 with TF32 off: greedy output of the continuous
          engine equals generate_sequential's token for token.
  train   the mtsl round (paper Alg. 1) through
          `repro_torch.launch.train`: paper-resnet16 at full width and
          depth (M = 10, b = 8, lr 0.1, 200 rounds), then paper-mlp
          (b = 16, 200 rounds), each at the launcher's default history
          cadence (every 20 rounds, the only host syncs). Checks that the
          launcher turned TF32 off, finite logged losses, a falling loss
          (round 200's below the mean of rounds 1 and 20), and that every
          parameter update launched K1: launches == leaves x rounds
          (17 x 200, 8 x 200), with the plain update run 0 times on the
          card. Reports rounds/s, samples/s, peak memory, acc_mtl on a
          held-out batch, and a torch.profiler pass over 20 more resnet
          rounds (device vs wall ms per round, K1's share, top kernels).
  tparity full paper-resnet16, M = 10, b = 8, TF32 off, participation
          0.5, the card (K1, cuDNN) against the CPU (plain version) from
          one initial tree and the same batches. Round-1 gradients per
          leaf, max |card - CPU| / max |CPU|: within 1e-12 in f64 (the
          witness that both compute one function) and within 2e-3 in
          f32, with the tower ReLU inputs that f32 rounds to the other
          side of 0 counted on each side. Then 3 rounds in f32: at lr
          0.01 losses within 1e-5 relative and every parameter within
          1e-5; at lr 0.1 losses within 1e-5 relative and the parameter
          gap reported (the f32 gradient gap times the step exceeds 1e-5
          there). Then two 20-round card runs from one seed under
          torch.use_deterministic_algorithms(True): bit-equal parameters.

Prints the card's name and power limit first, a `{"kernels": [...]}`
line, and as its last line `{"ok": true, "device": {...}}`. Without CUDA,
or without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off tensor cores
K4 = {"name": "flash_decode", "route": "cuda",
      "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
      "replaces": "src/repro/kernels/flash_decode/kernel.py:101"}
K1 = {"name": "mtsl_update", "route": "cuda",
      "source": "src/repro_torch/kernels/mtsl_update/csrc/mtsl_update.cu",
      "replaces": "src/repro/kernels/mtsl_update/kernel.py:25"}
# (case, shape, rows, dtype) beyond the train paths' own leaves
K1_FLAT_CASES = [
    ("flat_2^26_f32", (1 << 26,), 1, "float32"),
    ("flat_2^26_bf16", (1 << 26,), 1, "bfloat16"),
    ("odd_2003_f32", (2003,), 1, "float32"),
]
K1_MAIN_CASE = "paper-resnet16/towers/stage1/b0/conv2/w"  # [10, 3, 3, 32, 32]
TRAIN_RUNS = [  # (arch, batch per client, K1 leaves per round)
    ("paper-resnet16", 8, 17),
    ("paper-mlp", 16, 8),
]
ROUNDS = 200
LOG_EVERY = 20  # the launcher's history cadence (TrainConfig's default)
# round-1 gradients, card against CPU, max |a - b| / max |b| of the worst
# leaf, set from the readings on an H100 (PERF.md): f64, the witness that
# both compute one function (read: 8.3e-16), and f32 (read: 9.8e-4, twice
# that allowed). The f32 gap is not summation noise alone: a few tower
# ReLU inputs lie within 2.2e-7 of 0, and f32 rounds them to the other
# side on the card (4) and on the CPU (0 to 3), each flip moving whole
# gradient terms
GRAD_GAP_F64 = 1e-12
GRAD_GAP_F32 = 2e-3


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _median_ms(fn, iters: int, flush) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()  # the serving path finds each layer's cache cold in L2
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def kernel_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # (name, B, cap, Hq, Hkv, D, window, dtype, kv_valid range)
        ("serving_path", 4, 320, 16, 8, 256, 1024, "bfloat16", (64, 289)),
        ("b8_cap512_full", 8, 512, 16, 8, 256, 0, "bfloat16", (1, 513)),
        ("b8_cap512_swa", 8, 512, 16, 8, 256, 1024, "bfloat16", (1, 513)),
        ("b8_cap4096_full", 8, 4096, 16, 8, 256, 0, "bfloat16", (1, 4097)),
        ("b8_cap4096_swa", 8, 4096, 16, 8, 256, 1024, "bfloat16", (1, 4097)),
        ("b8_cap4096_swa_f32", 8, 4096, 16, 8, 256, 1024, "float32", (1, 4097)),
    ]
    tol = {"bfloat16": 2e-2, "float32": 2e-5}
    rows = []
    for name, B, cap, Hq, Hkv, D, window, dt, (lo, hi) in cases:
        dtype = getattr(torch, dt)
        q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, cap, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, cap, Hkv, D, generator=gen, device=dev).to(dtype)
        kv_valid = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                                 dtype=torch.int32)
        kv_valid[-1] = hi - 1  # one row full
        q_offset = kv_valid - 1
        kw = dict(kv_valid=kv_valid, q_offset=q_offset, window=window)
        out = flash_decode(q, k, v, **kw)
        ref = decode_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= tol[dt]:
            raise AssertionError(f"K4 {name}: max |kernel - plain| {err} > {tol[dt]}")

        kpos = torch.arange(cap, device=dev)
        mask = kpos[None, :] < kv_valid[:, None]
        if window:
            mask &= kpos[None, :] > q_offset[:, None] - window
        visible = int(mask.sum().item())
        elt = q.element_size()
        nbytes = (2 * visible * Hkv * D + 2 * B * Hq * D) * elt + 2 * 4 * B
        flops = 4 * visible * Hq * D
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = mask[:, None, None, :]
        row = {
            "case": name, "B": B, "cap": cap, "window": window, "dtype": dt,
            "max_abs_err": err,
            "ms": _median_ms(lambda: flash_decode(q, k, v, **kw), 50, flush),
            "plain_ms": _median_ms(lambda: decode_reference(q, k, v, **kw), 10,
                                   flush),
            "library_ms": _median_ms(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=amask, enable_gqa=True), 20, flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "visible_rows": visible,
        }
        rows.append(row)
        print(f"  K4 {name}: err {err:.3g}  kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    del flush
    return rows


def slice_phase(torch):
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference
    from repro_torch.launch import serve
    from repro_torch.models import layers

    M, new_tokens, vocab = 2, 32, 262_144
    argv = ["--arch", "gemma3-12b", "--no-smoke", "--device", "cuda",
            "--num-clients", str(M), "--batch-per-client", "4",
            "--slots", "4", "--chunk", "64", "--prompt-len", "256",
            "--min-prompt-len", "64", "--new-tokens", str(new_tokens),
            "--engine", "continuous", "--bench", "--profile", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = 0
    layers.attn_decode.calls = 0
    decode_reference.cuda_calls = 0
    t0 = time.perf_counter()
    m = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = flash_decode.launches, layers.attn_decode.calls
    plain = decode_reference.cuda_calls

    outs = m["outputs"]
    if len(outs) != 2 * 4:
        raise AssertionError(f"{len(outs)} requests returned, want 8")
    for i, o in enumerate(outs):
        if o.shape != (new_tokens,) or o.min() < 0 or o.max() >= vocab:
            raise AssertionError(f"request {i}: bad tokens {o}")
    if not m["logits_finite"]:
        raise AssertionError("non-finite logits")
    per_step = 6 * M + 42
    if not (launches == calls == per_step * m["decode_steps"] and launches > 0):
        raise AssertionError(
            f"K4 launches {launches}, attn_decode calls {calls}, decode steps "
            f"{m['decode_steps']} x {per_step}")
    if plain != 0:
        raise AssertionError(f"plain decode ran {plain} times on the card")
    return {"prefill_ms": m["prefill_ms"], "decode_tok_s": m["decode_tok_s"],
            "tok_s_per_slot": m["tok_s_per_slot"], "slots": m["slots"],
            "decode_steps": m["decode_steps"], "extend_chunks": m["extend_chunks"],
            "k4_launches": launches, "attn_decode_calls": calls,
            "k4_launches_per_decode_step": per_step, "profile": m["profile"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "phase_s": wall}


def parity_phase(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.launch.serve import init_params
    from repro_torch.models import build_model, layers
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-12b").with_updates(num_layers=12, dtype="float32")
    model = build_model(cfg)
    M, max_len = 2, 64
    params = init_params(model, M, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    lens, new = [5, 23, 40, 17], [8, 6, 8, 7]
    prompts = [rng.integers(0, cfg.vocab_size, size=L) for L in lens]
    n0, c0 = flash_decode.launches, layers.attn_decode.calls

    eng = ContinuousEngine(model, params, M, max_len, slots=2, chunk=16,
                           device="cuda")
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(Request(id=i, client=i % M, tokens=p, new_tokens=n))
    res = eng.run()
    seq = ServeEngine(model, params, M, max_len, device="cuda")
    for i, (p, n) in enumerate(zip(prompts, new)):
        toks = np.zeros((M, 1, len(p)), np.int64)
        toks[i % M, 0] = p
        ref = seq.generate_sequential({"tokens": toks}, n)[i % M, 0].numpy()
        if not (res[i] == ref).all():
            raise AssertionError(f"request {i}: continuous {res[i]} != "
                                 f"sequential {ref}")
    if flash_decode.launches - n0 != layers.attn_decode.calls - c0:
        raise AssertionError("a decode attention bypassed K4 in the parity phase")
    return {"requests": len(prompts), "tokens": int(sum(new)),
            "k4_launches": flash_decode.launches - n0}


def build_phase() -> dict:
    """Build every kernel at once, one nvcc per source; the registers lines
    of each ptxas report."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops as k4_ops
    from repro_torch.kernels.mtsl_update import ops as k1_ops

    libs = {"flash_decode": k4_ops._lib, "mtsl_update": k1_ops._lib}
    with ThreadPoolExecutor(len(libs)) as ex:
        for fut in [ex.submit(fn) for fn in libs.values()]:
            fut.result()
    return {name: [ln.strip() for ln in build.BUILD_LOGS.get(name, "").splitlines()
                   if "registers" in ln] for name in libs}


def k1_cases(torch) -> list:
    """(case, shape, rows, dtype, paths) of K1: every leaf that a train
    path updates, read from the initial tree of each TRAIN_RUNS model at
    full size (tower leaves [M, ...] take one step size per client, R = M;
    server leaves R = 1), one case per distinct shape named after its
    first leaf; then the flat cases."""
    from repro_torch.configs import get_config
    from repro_torch.core.mtsl import init_state
    from repro_torch.core.split import is_client_path
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves_with_path

    cases = {}
    for arch, _, _ in TRAIN_RUNS:
        cfg = get_config(arch)
        M = cfg.num_clients
        tree = init_state(build_model(cfg), torch.Generator().manual_seed(0), M)
        for path, leaf in tree_leaves_with_path(tree):
            key = (tuple(leaf.shape), M if is_client_path(path) else 1,
                   str(leaf.dtype).removeprefix("torch."))
            cases.setdefault(key, []).append(f"{arch}/{path}")
    return ([(paths[0], *key, paths) for key, paths in cases.items()]
            + [(*c, []) for c in K1_FLAT_CASES])


def k1_phase(torch, dev):
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows_out = []
    for name, shape, rows, dt, paths in k1_cases(torch):
        dtype = getattr(torch, dt)
        p = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        eta = torch.rand(rows, generator=gen, device=dev) * 10
        if rows > 1:
            eta[0] = 0.0  # a non-participating client: bit-frozen
        ref = mtsl_update_reference(p, g, eta)
        out = mtsl_update_(p.clone(), g, eta)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 {name}: kernel != plain (max |diff| {err})")
        pk, pl = p.clone(), p.clone()
        if rows == 1:
            a = float(eta[0])

            def library():
                return pl.add_(g, alpha=-a)
        else:
            def library():
                return pl.view(rows, -1).addcmul_(eta[:, None], g.view(rows, -1),
                                                  value=-1)
        t_bytes = 3 * p.numel() * p.element_size() / HBM_BYTES_PER_S
        row = {
            "case": name, "shape": list(shape), "rows": rows, "dtype": dt,
            "leaves": paths, "max_abs_err": err, "bit_equal": True,
            "ms": _median_ms(lambda: mtsl_update_(pk, g, eta), 50, flush),
            "plain_ms": _median_ms(lambda: mtsl_update_reference(p, g, eta), 20,
                                   flush),
            "library_ms": _median_ms(library, 20, flush),
            "bound_ms": t_bytes * 1e3, "bound_by": "bytes",
        }
        rows_out.append(row)
        print(f"  K1 {name} {tuple(shape)} R={rows} {dt} ({len(paths)} leaves): "
              f"bit-equal  kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library "
              f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms",
              flush=True)
    del flush
    return rows_out


def _held_out_batch(cfg, M, per_task=64, seed=123):
    """Each task's test set (its main class only, paper §4.1), as the
    reference benchmarks draw it."""
    import numpy as np

    from repro_torch.data.synthetic import MultiTaskImageSource

    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    rng = np.random.default_rng(seed)
    xs, ys = zip(*(src.test_batch(rng, m, per_task) for m in range(M)))
    return {"image": np.stack(xs), "label": np.stack(ys).astype(np.int32)}


def train_phase(torch, dev, arch: str, b: int, leaves: int, rounds: int = ROUNDS):
    """The mtsl main path through the launcher as a user runs it (history
    every LOG_EVERY rounds, so the host reads the loss back only then), with
    K1's counts set to 0 just before and read just after. The loss checks
    read the logged rounds: rounds 1 and 20 against round 200."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch

    argv = ["--arch", arch, "--algorithm", "mtsl", "--device", dev.type,
            "--steps", str(rounds), "--batch-per-client", str(b), "--lr", "0.1",
            "--seed", "0"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the
        # launcher must turn it off itself
    mtsl_update_.launches = 0
    mtsl_update_reference.cuda_calls = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state, hist = launch_train.main(argv)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = mtsl_update_.launches, mtsl_update_reference.cuda_calls
    if dev.type == "cuda" and (torch.backends.cudnn.allow_tf32
                               or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError(f"{arch}: the launcher left TF32 on")

    logged = sorted({1, rounds} | set(range(LOG_EVERY, rounds + 1, LOG_EVERY)))
    loss = np.array([e["loss"] for e in hist])
    r = np.array([e["round"] for e in hist])
    if r.tolist() != logged or not np.isfinite(loss).all():
        raise AssertionError(f"{arch}: history rounds {r.tolist()}, finite "
                             f"{np.isfinite(loss).all()}")
    first, last = loss[r <= 20].mean(), loss[r > rounds - 20].mean()
    if not last < first:
        raise AssertionError(f"{arch}: loss did not fall ({first} -> {last})")
    if dev.type == "cuda" and not (launches == leaves * rounds and plain == 0):
        raise AssertionError(f"{arch}: K1 launches {launches}, want {leaves} x "
                             f"{rounds}; plain updates on the card {plain}")
    cfg = get_config(arch)
    M = cfg.num_clients
    model = build_model(cfg)
    ev = get_algorithm("mtsl").eval_fn(model, M)(
        state, stage_batch(_held_out_batch(cfg, M), dev))
    steady_s = (hist[-1]["time"] - hist[0]["time"]) / (rounds - 1)
    res = {
        "arch": arch, "M": M, "batch_per_client": b, "rounds": rounds,
        "k1_launches": launches, "k1_leaves": leaves, "plain_updates_on_card": plain,
        "loss_first20": float(first), "loss_last20": float(last),
        "final_loss": float(loss[-1]), "acc_mtl_held_out": float(ev["acc_mtl"]),
        "phase_s": wall, "ms_per_round": steady_s * 1e3,
        "rounds_per_s": 1.0 / steady_s, "samples_per_s": M * b / steady_s,
    }
    if dev.type == "cuda":
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res, state


def train_profile_phase(torch, dev, state, arch="paper-resnet16", b=8, rounds=20):
    """One torch.profiler pass over `rounds` more mtsl rounds from `state`,
    each as the launcher runs it (numpy synthesis, staging, round)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import full_schedule
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch

    cfg = get_config(arch)
    M = cfg.num_clients
    rf = get_algorithm("mtsl").round_fn(
        build_model(cfg), M, HParams(lr=0.1, component_lr=server_scaled(M)))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=1)
    batches = client_batches(src, b, seed=1)
    sched = full_schedule(M, 1)
    state, _ = rf(state, stage_batch(next(batches), dev), sched)  # warm
    torch.cuda.synchronize()
    data_s = 0.0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            td = time.perf_counter()
            batch = next(batches)
            data_s += time.perf_counter() - td
            state, metrics = rf(state, stage_batch(batch, dev), sched)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "mtsl_update" in e.key) / 1e3
    return {
        "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "device_ms_per_round": device_ms / rounds,
        "device_busy_share": device_ms / wall_ms,
        "host_data_ms_per_round": data_s * 1e3 / rounds,
        "k1_device_ms_per_round": k1_ms / rounds,
        "kernel_launches_per_round": sum(e.count for e in kernels) / rounds,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_round": e.self_device_time_total / 1e3 / rounds,
             "calls_per_round": e.count / rounds} for e in kernels[:10]],
    }


def _parity_setup(rounds: int):
    """What the parity phases start from: full paper-resnet16 (M = 10,
    b = 8), its initial tree on the CPU, `rounds` round batches and their
    masked schedules (participation 0.5), all from seed 3."""
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.schedule import ScheduleConfig, schedule_stream
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.utils.device import generator

    cfg = get_config("paper-resnet16")
    M, b = cfg.num_clients, 8
    model = build_model(cfg)
    init = get_algorithm("mtsl").init_state(model, generator("cpu", 3), M, HParams())
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=3)
    batches = list(client_batches(src, b, steps=rounds, seed=3))
    scheds = schedule_stream(ScheduleConfig(participation_rate=0.5, seed=3), M, 1)
    return model, M, init.params, list(zip(batches, scheds))


def _relu_flips(torch, model, towers, image, truth=None):
    """The towers' ReLU inputs under vmap, as f64 on the CPU; with `truth`
    (the same from an f64 run), per ReLU call that has any, the count of
    inputs whose sign differs from truth's and the largest |truth| among
    them."""
    import torch.nn.functional as F

    class Record(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is F.relu:
                self.seen.append(args[0])
            return func(*args, **(kwargs or {}))

    def fwd(tp, x):
        mode = Record()
        mode.seen = []
        with mode:
            model.tower_forward(tp, {"image": x})
        return mode.seen

    acts = [a.detach().cpu().double() for a in torch.func.vmap(fwd)(towers, image)]
    if truth is None:
        return acts
    flips = {}
    for i, (a, t) in enumerate(zip(acts, truth)):
        f = (a > 0) != (t > 0)
        if f.any():
            flips[f"relu{i}"] = [int(f.sum()), float(t[f].abs().max())]
    return flips


def gradient_gap_phase(torch, dev):
    """Round-1 gradients of the parity phases' first round on `dev` and on
    the CPU, from one tree and batch, in f32 and in f64. Per leaf the gap
    is max |a - b| / max |b|; each reading names its worst leaf. If the
    card and the CPU compute one function, their f64 gradients agree to
    rounding (~1e-12 at most). Also counts the tower ReLU inputs whose
    sign in f32 differs from f64's on each side: such a flip moves whole
    gradient terms, far above f32 rounding."""
    from repro_torch.core.algorithms import schedule_tensors
    from repro_torch.core.mtsl import TrainState, build_train_phases
    from repro_torch.optim import sgd
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    model, M, init, [(batch, sched)] = _parity_setup(1)
    local_step, _ = build_train_phases(model, sgd(0.1), M)
    grads, flips, truth = {}, {}, None
    for where in ("cpu", dev.type):
        for dt in (torch.float64, torch.float32):
            params = tree_map(lambda x: x.detach().to(where, dt).requires_grad_(), init)
            staged = {k: v.to(dt) if v.is_floating_point() else v
                      for k, v in stage_batch(batch, where).items()}
            mask, sizes = schedule_tensors(sched, where)
            g, _ = local_step(TrainState(params, (), 0), staged, mask, sizes)
            grads[where, dt] = {k: v.detach().cpu().double()
                                for k, v in tree_leaves_with_path(g)}
            with torch.no_grad():
                seen = _relu_flips(torch, model, params["towers"], staged["image"], truth)
            if truth is None:
                truth = seen
            else:
                side = "cpu" if where == "cpu" else "card"
                flips[f"{side}_{str(dt).removeprefix('torch.')}"] = seen

    def gap(a, b):
        rel, leaf = max(
            (float((grads[a][k] - ref).abs().max()) / (float(ref.abs().max()) or 1.0), k)
            for k, ref in grads[b].items())
        return {"rel": rel, "leaf": leaf,
                "leaf_max_abs_grad": float(grads[b][leaf].abs().max())}

    f32, f64 = torch.float32, torch.float64
    res = {"card_vs_cpu_f32": gap((dev.type, f32), ("cpu", f32)),
           "card_vs_cpu_f64": gap((dev.type, f64), ("cpu", f64)),
           "card_f32_vs_f64": gap((dev.type, f32), ("cpu", f64)),
           "cpu_f32_vs_f64": gap(("cpu", f32), ("cpu", f64)),
           "card_vs_cpu_f32_by_leaf": {
               k: float((grads[dev.type, f32][k] - ref).abs().max())
               / (float(ref.abs().max()) or 1.0)
               for k, ref in grads["cpu", f32].items()},
           "relu_flips_vs_cpu_f64": flips,
           "participants": sched.num_participants}
    if not res["card_vs_cpu_f64"]["rel"] <= GRAD_GAP_F64:
        raise AssertionError(f"f64 gradients, card vs CPU: {res}")
    if not res["card_vs_cpu_f32"]["rel"] <= GRAD_GAP_F32:
        raise AssertionError(f"f32 gradients, card vs CPU: {res}")
    return res


def _card_vs_cpu_rounds(torch, lr: float, rounds: int = 3):
    """`rounds` masked mtsl rounds of full paper-resnet16 (M = 10, b = 8)
    on the card and on the CPU from one tree and one batch stream. Returns
    per round the card's and the CPU's loss, the participants, and the
    largest parameter gap with the leaf it is in; raises if a loss differs
    by more than 1e-5 relative or a card update bypassed K1."""
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.mtsl import TrainState
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    model, M, init, stream = _parity_setup(rounds)
    alg = get_algorithm("mtsl")
    hp = HParams(lr=lr, component_lr=server_scaled(M))
    cpu = TrainState(tree_map(lambda x: x.detach().clone().requires_grad_(), init),
                     (), 0)
    gpu = TrainState(tree_map(lambda x: x.detach().cuda().requires_grad_(), init),
                     (), 0)
    rf_cpu, rf_gpu = alg.round_fn(model, M, hp), alg.round_fn(model, M, hp)
    n0 = mtsl_update_.launches
    per_round = []
    for batch, sched in stream:
        gpu, mg = rf_gpu(gpu, stage_batch(batch, "cuda"), sched)
        cpu, mc = rf_cpu(cpu, stage_batch(batch, "cpu"), sched)
        lg, lc = float(mg["loss"]), float(mc["loss"])
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"lr {lr}: card loss {lg} vs CPU {lc}")
        cpu_leaves = dict(tree_leaves_with_path(cpu.params))
        err, leaf = max(((a.detach().cpu() - cpu_leaves[k].detach()).abs().max().item(), k)
                        for k, a in tree_leaves_with_path(gpu.params))
        per_round.append({"card_loss": lg, "cpu_loss": lc,
                          "participants": sched.num_participants,
                          "max_param_abs_diff": err, "worst_leaf": leaf})
    if mtsl_update_.launches - n0 != 17 * rounds:
        raise AssertionError("a card update bypassed K1 in the parity phase")
    return per_round


def train_parity_phase(torch):
    """Card against CPU, then seeded repeatability on the card.

    First the round-1 gradients (`gradient_gap_phase`): the f64 pair must
    agree within GRAD_GAP_F64, the f32 pair within GRAD_GAP_F32. Then the
    parameters of 3 rounds are held within 1e-5 at lr 0.01. At the train
    slice's lr 0.1 an f32 gradient gap of that size moves the parameters by
    more than 1e-5, so there only the losses are held (1e-5 relative) and
    the parameter gap is reported."""
    from repro_torch.launch import train as launch_train
    from repro_torch.utils.tree import tree_leaves

    grads = gradient_gap_phase(torch, torch.device("cuda"))
    held = _card_vs_cpu_rounds(torch, 0.01)
    err = max(r["max_param_abs_diff"] for r in held)
    if not err <= 1e-5:
        raise AssertionError(f"lr 0.01: card vs CPU params differ by {err}: {held}")
    reported = _card_vs_cpu_rounds(torch, 0.1)

    argv = ["--arch", "paper-resnet16", "--device", "cuda", "--steps", "20",
            "--batch-per-client", "8", "--lr", "0.1", "--seed", "5",
            "--participation-rate", "0.5"]
    torch.use_deterministic_algorithms(True)
    try:
        finals = []
        for _ in range(2):
            with contextlib.redirect_stdout(io.StringIO()):
                state, _ = launch_train.main(argv)
            finals.append([x.detach().clone() for x in tree_leaves(state.params)])
    finally:
        torch.use_deterministic_algorithms(False)
    if not all(torch.equal(a, c) for a, c in zip(*finals)):
        raise AssertionError("two seeded 20-round card runs differ")
    return {"round1_grad_gap": grads, "lr0.01": held, "lr0.1": reported,
            "repeat_rounds": 20,
            "repeat_bit_equal": True}


def main() -> int:
    # cuBLAS reproducibility under use_deterministic_algorithms (tparity);
    # must be set before CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return _fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
                     "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          "nvidia-smi: no output", flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}  device {torch.cuda.get_device_name(0)}",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    try:
        t0 = time.perf_counter()
        regs = build_phase()
        report["build_s"] = time.perf_counter() - t0
        print(f"[build] flash_decode and mtsl_update in {report['build_s']:.1f} s",
              flush=True)
        for name, lines in regs.items():
            print(f"  ptxas {name}: {lines}", flush=True)

        print("[kernel] K4 vs its plain version", flush=True)
        cases = kernel_phase(torch, dev)
        print("KERNEL_CASES " + json.dumps(cases), flush=True)

        print("[k1] K1 vs its plain version (bit-equal)", flush=True)
        k1_cases = k1_phase(torch, dev)
        print("K1_CASES " + json.dumps(k1_cases), flush=True)

        print("[slice] gemma3-12b full width/depth, M=2, continuous", flush=True)
        report["slice"] = slice_phase(torch)
        print("SLICE " + json.dumps(report["slice"]), flush=True)
        torch.cuda.empty_cache()

        print("[parity] full width, 6+6 layers, f32: continuous == sequential",
              flush=True)
        report["parity"] = parity_phase(torch)
        print("PARITY " + json.dumps(report["parity"]), flush=True)
        torch.cuda.empty_cache()

        report["train"] = []
        for arch, b, leaves in TRAIN_RUNS:
            print(f"[train] {arch} full width/depth, mtsl, {ROUNDS} rounds", flush=True)
            res, state = train_phase(torch, dev, arch, b, leaves)
            if arch == "paper-resnet16":
                res["profile"] = train_profile_phase(torch, dev, state)
            del state
            report["train"].append(res)
            print("TRAIN " + json.dumps(res), flush=True)

        print("[tparity] paper-resnet16, 3 masked rounds: card == CPU; seeded "
              "repeatability", flush=True)
        report["tparity"] = train_parity_phase(torch)
        print("TPARITY " + json.dumps(report["tparity"]), flush=True)
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        return _fail("a phase failed")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k4 = dict(K4, launches=report["slice"]["k4_launches"],
              **{key: cases[0][key] for key in keys})
    k1_case = next(c for c in k1_cases if c["case"] == K1_MAIN_CASE)
    k1 = dict(K1, launches=report["train"][0]["k1_launches"],
              **{key: k1_case[key] for key in keys})
    print(json.dumps({"kernels": [k4, k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
