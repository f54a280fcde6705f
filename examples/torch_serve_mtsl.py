"""Serve a split model on the PyTorch port (the twin of
examples/serve_mtsl.py) with batched requests routed through per-client
MTSL towers: requests from client m run through psi_m + the shared server
stack, with chunked prefill and KV / SSM-cache decode on the
continuous-batching engine. The reduced (smoke) variant of the arch, from
random weights; runs on the card unless --device cpu.

    PYTHONPATH=src python examples/torch_serve_mtsl.py --arch gemma3-12b
    PYTHONPATH=src python examples/torch_serve_mtsl.py --arch mamba2-130m \
        --new-tokens 32 --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.serve import init_params
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampling import fold_in


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)  # the reduced variant
    model = build_model(cfg)
    if model.tower_prefill is None:
        raise SystemExit(f"--arch {args.arch}: serving of the {cfg.family} "
                         "family is not ported yet")
    M, b = cfg.num_clients, args.batch_per_client
    params = init_params(model, M, 0, args.device)
    engine = ServeEngine(model, params, M,
                         max_len=args.prompt_len + args.new_tokens,
                         device=args.device)

    rng = np.random.default_rng(10)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size,
                                     size=(M, b, args.prompt_len))}
    t0 = time.perf_counter()
    out = engine.generate(inputs, args.new_tokens,
                          temperature=args.temperature, rng=fold_in(0, 2))
    dt = time.perf_counter() - t0
    total = M * b * args.new_tokens
    print(f"arch={cfg.name}  requests={M*b} (routed to {M} client towers)")
    print(f"generated {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s)")
    for m in range(min(M, 3)):
        print(f"  client {m} sample:", out[m, 0].numpy()[:12])


if __name__ == "__main__":
    main()
