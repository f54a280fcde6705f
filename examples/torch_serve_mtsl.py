"""Serve a split model on the PyTorch port (the twin of
examples/serve_mtsl.py) with batched requests routed through per-client
MTSL towers: requests from client m run through psi_m + the shared server
stack, with prefill and KV / SSM-cache decode: chunked prefill on the
continuous-batching engine, or, for the families without it (the VLM and
the encoder-decoder, whose vision features / audio frames are drawn
beside the prompts), the sequential engine. Every servable arch, in its
reduced (smoke) variant, from random weights; runs on the card unless
--device cpu.

    PYTHONPATH=src python examples/torch_serve_mtsl.py --arch gemma3-12b
    PYTHONPATH=src python examples/torch_serve_mtsl.py --arch mamba2-130m \
        --new-tokens 32 --device cpu
    PYTHONPATH=src python examples/torch_serve_mtsl.py --device cpu \
        --arch llama-3.2-vision-11b   # or whisper-tiny, deepseek-moe-16b
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.launch.serve import init_params, seeded_inputs
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampling import fold_in


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)  # the reduced variant
    model = build_model(cfg)
    M, b = cfg.num_clients, args.batch_per_client
    params = init_params(model, M, 0, args.device)
    engine = ServeEngine(model, params, M,
                         max_len=args.prompt_len + args.new_tokens,
                         device=args.device)

    inputs = seeded_inputs(cfg, M, b, args.prompt_len, 10)
    t0 = time.perf_counter()
    out = engine.generate(inputs, args.new_tokens,
                          temperature=args.temperature, rng=fold_in(0, 2))
    dt = time.perf_counter() - t0
    total = M * b * args.new_tokens
    print(f"arch={cfg.name}  requests={M*b} (routed to {M} client towers)")
    print(f"generated {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s)")
    for m in range(min(M, 3)):
        print(f"  client {m} sample:", out[m, 0].numpy()[:12])
    return out


if __name__ == "__main__":
    main()
