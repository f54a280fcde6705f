#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (`src/repro_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  build   nvcc builds every kernel of the serving path from the sources in
          this checkout (K4, flash-decode, for sm_90a).
  kernel  K4 against its plain PyTorch version on the card at the serving
          path's shapes (4 slots, cap 320) and at 8 rows with ragged
          kv_valid, cap in {512, 4096}, window in {0, 1024}: bf16 within
          2e-2, one f32 case within 2e-5. Times the kernel, the plain
          version, F.scaled_dot_product_attention with the same mask (a
          yardstick only: the port never calls it) and the bound (bytes
          over 3.35 TB/s or flops over the dtype's peak, whichever is
          larger), each launch behind an L2 flush.
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

Prints the card's name and power limit first, a `{"kernels": [...]}`
line, and as its last line `{"ok": true, "device": {...}}`. Without CUDA,
or without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off tensor cores
K4 = {"name": "flash_decode", "route": "cuda",
      "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
      "replaces": "src/repro/kernels/flash_decode/kernel.py:101"}


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


def main() -> int:
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
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_decode import ops

        t0 = time.perf_counter()
        ops._lib()
        report["build_s"] = time.perf_counter() - t0
        regs = [ln.strip() for ln in build.BUILD_LOGS.get("flash_decode", "").splitlines()
                if "registers" in ln]
        print(f"[build] flash_decode in {report['build_s']:.1f} s; {regs}", flush=True)

        print("[kernel] K4 vs its plain version", flush=True)
        cases = kernel_phase(torch, dev)
        print("KERNEL_CASES " + json.dumps(cases), flush=True)

        print("[slice] gemma3-12b full width/depth, M=2, continuous", flush=True)
        report["slice"] = slice_phase(torch)
        print("SLICE " + json.dumps(report["slice"]), flush=True)
        torch.cuda.empty_cache()

        print("[parity] full width, 6+6 layers, f32: continuous == sequential",
              flush=True)
        report["parity"] = parity_phase(torch)
        print("PARITY " + json.dumps(report["parity"]), flush=True)
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        return _fail("a phase failed")

    main_case = cases[0]
    k4 = dict(K4, launches=report["slice"]["k4_launches"],
              **{key: main_case[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "library_ms")})
    print(json.dumps({"kernels": [k4]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
