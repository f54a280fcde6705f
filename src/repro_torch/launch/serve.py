"""Serving launcher (port of `repro.launch.serve`): loads a checkpoint (or
random-inits a split model from a seed) and serves batched requests with
per-client routing through the MTSL towers. Runs on CUDA unless
`--device cpu` is given. The default arch is mamba2-130m, as the
reference's; every LM family serves: dense (gemma3-12b, ...; the
sliding-window `mistral-nemo-12b-swa` on ring KV caches, full config
only), moe, ssm, hybrid (zamba2-7b), vlm (llama-3.2-vision-11b) and
encdec (whisper-tiny). The VLM's vision features and the
encoder-decoder's audio frames (stub frontends, as in the reference) are
drawn from the seed beside the prompts.

Engines: `--engine continuous` (chunked prefill, slots) or `sequential`;
by default continuous where the model allows it. The vlm and encdec
families (no chunked prefill) and ring caches take the sequential engine
only, and an explicit `--engine continuous` for them is refused with the
reference's message.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --prompt-len 12 --new-tokens 6
    # a checkpoint of either package: an Algorithm-registry state
    # (launch/train.py --checkpoint) or a {"params", "step"} file (the LM
    # example's --full run), for the config the flags name
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
        --checkpoint /tmp/mtsl_lm.msgpack
    # timed serving smoke (prefill ms / decode tok/s / tok/s/slot):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --bench --engine continuous
    # the VLM and the encoder-decoder (sequential engine):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
        --arch whisper-tiny --prompt-len 12 --new-tokens 6
    # gemma3-12b (or zamba2-7b, deepseek-moe-16b) at full width on one
    # card, 2 clients, 8 mixed-length requests over 4 slots:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --no-smoke --num-clients 2 --batch-per-client 4 --slots 4 \
        --chunk 64 --prompt-len 256 --min-prompt-len 64 --new-tokens 32 \
        --bench

Both engines run their decode steps (and the continuous engine its extend
steps) as CUDA graphs on the card (`serve/graphs.py`): `--bench` reports
the graphs captured, the milliseconds their warm-ups and captures took
(set-up, outside the timed phases) and the bytes of the engine's graph
pool.

Unlike the reference's `--smoke` (store_true with default True), `--smoke`
here can be turned off (`--no-smoke`), so the full config is reachable. A
checkpoint holds the training tree (f32 masters in the reference's layout);
it is served as the serving tree (matmul weights in cfg.dtype), with the
number of clients its towers have.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.split import stack_towers
from repro_torch.models.registry import build_model
from repro_torch.serve.continuous import continuous_refusal
from repro_torch.serve.engine import ServeEngine, stage_inputs
from repro_torch.serve.sampling import fold_in
from repro_torch.train.checkpoint import load_checkpoint
from repro_torch.utils.convert import params_from_jax, state_from_jax, to_serving_tree
from repro_torch.utils.device import generator, resolve_device
from repro_torch.utils.tree import tree_leaves


def init_params(model, num_clients: int, seed: int, device):
    """The serving tree {"towers": [M, ...]-stacked, "server": ...} drawn
    from `seed`."""
    gen = generator(device, seed)
    return {"towers": stack_towers(lambda g: model.init_tower(g, serving=True),
                                   gen, num_clients),
            "server": model.init_server(gen, serving=True)}


def load_serve_params(path: str, model, device):
    """The serving tree {"towers", "server"} of a checkpoint of either
    format: an Algorithm-registry state (train/loop.py) or a raw
    {"params": ...} tree (the LM example), both in the reference's
    layout."""
    tree = load_checkpoint(path)
    cfg = model.cfg
    if isinstance(tree, dict) and "algorithm" in tree and "state" in tree:
        from repro_torch.core.algorithms import get_algorithm

        alg = get_algorithm(tree["algorithm"])
        if alg.serve_params is None:
            raise SystemExit(
                f"algorithm {alg.name!r} states are not directly servable "
                "(per-client servers / mixtures have no single split model)")
        state = state_from_jax(alg.name, alg.state_from_tree(tree["state"]),
                               device, cfg)
        params = alg.serve_params(state)
    else:
        params = params_from_jax(tree["params"], device, cfg)
    return to_serving_tree(model, params)


def seeded_inputs(cfg, M: int, b: int, prompt_len: int, seed: int) -> dict:
    """A request batch drawn from `seed` with numpy: {"tokens" [M,b,L]}
    plus the VLM's "vis" [M,b,vis_seq,vis_dim] or the encoder-decoder's
    "frames" [M,b,encoder_seq,d_model] (standard normal, f32), the shapes
    the reference's launcher draws."""
    rng = np.random.default_rng(seed)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, size=(M, b, prompt_len))}
    if cfg.family == "vlm":
        inputs["vis"] = rng.standard_normal((M, b, cfg.vis_seq, cfg.vis_dim),
                                            dtype=np.float32)
    if cfg.family == "encdec":
        inputs["frames"] = rng.standard_normal((M, b, cfg.encoder_seq, cfg.d_model),
                                               dtype=np.float32)
    return inputs


def _prompts(cfg, n: int, prompt_len: int, min_prompt_len, seed: int):
    rng = np.random.default_rng(seed)
    lo = prompt_len if min_prompt_len is None else min_prompt_len
    lens = rng.integers(lo, prompt_len + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=int(L)) for L in lens]


PROFILE_STEPS = 8  # decode steps under the profiler (its events cost host time)


def _profile_decode(eng, submit_all) -> dict:
    """Device-time breakdown of PROFILE_STEPS more decode steps (the first
    wave's slots, all active) under torch.profiler: kernel time per step
    by kernel name, and the share of the wall time the card was busy. The
    wave then finishes outside the profiler."""
    from torch.profiler import ProfilerActivity, profile

    submit_all()
    eng.prefill_all()
    eng.sync()
    steps0 = eng.stats["decode_steps"]
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.decode_all(max_steps=PROFILE_STEPS)
        eng.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = max(eng.stats["decode_steps"] - steps0, 1)
    eng.run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {
        "decode_steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps} for e in kernels[:12]],
    }


def run_bench(model, params, cfg, M: int, b: int, prompt_len: int,
              new_tokens: int, engine_kind: str, chunk: int = 8, *,
              device="cuda", slots=None, min_prompt_len=None, seed=0,
              profile: bool = False, graphs: bool = True) -> dict:
    """Timed serving smoke: a warm-up (continuous: the engine's
    construction, which captures its steps, and one short request;
    sequential: the whole batch, whose first decode step captures), then a
    measured prefill phase and decode phase over M*b requests (request i
    is client i % M). Returns prefill_ms / decode_tok_s / tok_s_per_slot,
    and the engine's `captures`, `capture_ms` and `graph_pool_bytes`
    (`graphs=False` runs the same steps eagerly: a yardstick for the
    graphs, not a launcher option).

    continuous: `slots` (default M*b) cache slots; prompt lengths uniform
    in [min_prompt_len, prompt_len] (default: all prompt_len). The timed
    phases cover the first wave (as many requests as there are slots);
    the rest are then served interleaved by `run()`, and `outputs` holds
    every request's tokens. `profile` then serves the requests once more
    with a window of their decode steps profiled (`_profile_decode`).
    sequential: M*b rows in lockstep, on the
    generate path's inputs (`seeded_inputs`: the VLM's vision features
    and the encoder-decoder's frames too); prefill_ms includes the copy
    of the prefill's caches into the decode step's static buffers."""
    dev = resolve_device(device)
    n_req = M * b
    max_len = prompt_len + new_tokens

    if engine_kind == "continuous":
        from repro_torch.serve.continuous import ContinuousEngine, Request

        prompts = _prompts(cfg, n_req, prompt_len, min_prompt_len, seed)
        slots = slots or n_req
        chunk = min(chunk, prompt_len)
        eng = ContinuousEngine(model, params, M, max_len, slots=slots,
                               chunk=chunk, seed=seed, device=dev,
                               graphs=graphs)

        def submit_all():
            for i in range(n_req):
                eng.submit(Request(id=i, client=i % M, tokens=prompts[i],
                                   new_tokens=new_tokens))

        # warm-up: one request through one extend chunk and one decode step
        # runs every kernel of the path once (nothing to compile)
        eng.submit(Request(id=-1, client=0, tokens=prompts[0][:chunk],
                           new_tokens=2))
        eng.run()
        submit_all()
        eng.sync()
        t0 = time.perf_counter()
        n_chunks = eng.prefill_all()
        eng.sync()
        t1 = time.perf_counter()
        emitted = eng.decode_all()
        eng.sync()
        t2 = time.perf_counter()
        res = eng.run()  # serves the requests that found no free slot
        prefill_s, decode_s = t1 - t0, t2 - t1
        decode_tokens = emitted
        n_slots = slots
        extra = {"profile": _profile_decode(eng, submit_all)} if profile else {}
        sg = eng.graphs
        extra.update({"extend_chunks": n_chunks,
                 "decode_steps": eng.stats["decode_steps"],
                 "stats": dict(eng.stats),  # every pass, warm-up included
                 "logits_finite": eng.logits_finite(),
                 "outputs": [res[i] for i in range(n_req)]})
    else:
        if min_prompt_len is not None:
            raise ValueError("the sequential engine takes one prompt length")
        engine = ServeEngine(model, params, M, max_len, device=dev,
                             graphs=graphs)
        inputs = stage_inputs(seeded_inputs(cfg, M, b, prompt_len, seed), dev)
        out = engine.generate_sequential(inputs, new_tokens)  # warm-up
        _sync(dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, caches = engine._prefill(engine.params, inputs)
            tok = engine._sample(logits, 0.0, None, 0).reshape(M, b, 1)
            buf = engine.load_caches(caches, b, prompt_len)
            del caches
            _sync(dev)
            t1 = time.perf_counter()
            engine.decode(buf, tok, new_tokens)
            _sync(dev)
            t2 = time.perf_counter()
        prefill_s, decode_s = t1 - t0, t2 - t1
        decode_tokens = n_req * (new_tokens - 1)
        n_slots = n_req
        extra = {"outputs": list(out.reshape(n_req, new_tokens).numpy())}
        sg = engine.graphs

    decode_tok_s = decode_tokens / max(decode_s, 1e-9)
    return {
        "engine": engine_kind,
        "arch": cfg.name,
        "device": str(dev),
        "slots": n_slots,
        "prefill_ms": prefill_s * 1e3,
        "decode_tok_s": decode_tok_s,
        "tok_s_per_slot": decode_tok_s / n_slots,
        "graphs": sg.enabled,
        "captures": sg.captures,
        "capture_ms": sg.capture_ms,
        "graph_pool_bytes": sg.pool_bytes(),
        **extra,
    }


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the reduced smoke config (default); "
                    "--no-smoke for the full published config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--num-clients", type=int, default=None,
                    help="M client towers (default: the config's)")
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="--bench, continuous: prompt lengths uniform in "
                         "[min, --prompt-len]")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--engine", choices=("continuous", "sequential"),
                    default=None, help="default: continuous where the model "
                    "allows it (not vlm, encdec or ring caches), else sequential")
    ap.add_argument("--bench", action="store_true",
                    help="timed prefill/decode smoke instead of generation")
    ap.add_argument("--slots", type=int, default=None,
                    help="--bench, continuous: cache slots (default M*b)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="--bench, continuous: prefill chunk")
    ap.add_argument("--profile", action="store_true",
                    help="--bench, continuous: profile PROFILE_STEPS more decode "
                         "steps (kernel time per step, device busy share)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed: params init, prompts, and the engine's "
                         "per-request sampling keys")
    ap.add_argument("--checkpoint", default=None,
                    help="serve the weights of this checkpoint (either "
                         "package's format) instead of a random init")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":  # f32 matmuls in full f32, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    if model.tower_prefill is None:
        raise SystemExit(f"--arch {args.arch}: the {cfg.family} family has "
                         "no serving path")
    why = continuous_refusal(model)
    if args.engine == "continuous" and why:
        raise SystemExit(f"--engine continuous: {why}")
    engine_kind = args.engine or ("sequential" if why else "continuous")
    b = args.batch_per_client
    if args.checkpoint:
        params = load_serve_params(args.checkpoint, model, dev)
        M = tree_leaves(params["towers"])[0].shape[0]
        if args.num_clients not in (None, M):
            raise SystemExit(f"--num-clients {args.num_clients}: the checkpoint "
                             f"has {M} client towers")
    else:
        M = args.num_clients or cfg.num_clients
        params = init_params(model, M, args.seed, dev)

    if args.bench:
        metrics = run_bench(model, params, cfg, M, b, args.prompt_len,
                            args.new_tokens, engine_kind, args.chunk,
                            device=dev, slots=args.slots,
                            min_prompt_len=args.min_prompt_len, seed=args.seed,
                            profile=args.profile)
        print(f"[{metrics['engine']}] prefill {metrics['prefill_ms']:.1f} ms | "
              f"decode {metrics['decode_tok_s']:.1f} tok/s | "
              f"{metrics['tok_s_per_slot']:.1f} tok/s/slot "
              f"({metrics['slots']} slots, {metrics['device']}) | "
              f"{metrics['captures']} graphs captured in "
              f"{metrics['capture_ms']:.0f} ms")
        return metrics

    max_len = args.prompt_len + args.new_tokens
    engine = ServeEngine(model, params, M, max_len, sample_seed=args.seed,
                         device=dev)
    inputs = seeded_inputs(cfg, M, b, args.prompt_len, args.seed)
    gen = (engine.generate if engine_kind == "continuous"
           else engine.generate_sequential)
    t0 = time.perf_counter()
    out = gen(inputs, args.new_tokens, temperature=args.temperature,
              rng=fold_in(args.seed, 2))
    dt = time.perf_counter() - t0
    total = M * b * args.new_tokens
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {dev})")
    print("sample (client 0):", out[0, 0].numpy()[:16])
    return out


if __name__ == "__main__":
    main()
