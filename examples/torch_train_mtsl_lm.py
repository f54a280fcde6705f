"""End-to-end driver on the PyTorch port (the twin of
examples/train_mtsl_lm.py): train a Mamba2-family LM with MTSL on
heterogeneous per-client Markov-chain corpora, report per-task loss
against each client's entropy floor, and write a `{"params", "step"}`
checkpoint in the reference's file format (either package reads it; the
`--full` one serves with `repro_torch.launch.serve --no-smoke
--checkpoint PATH`).

Default is a ~20M-param reduction; --full trains the real mamba2-130m
config (129M params). Runs on the card unless --device cpu.

    PYTHONPATH=src python examples/torch_train_mtsl_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_mtsl_lm.py --full --steps 300
    PYTHONPATH=src python examples/torch_train_mtsl_lm.py --device cpu \
        --steps 2 --batch-per-client 2 --seq-len 64
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import lr_policy
from repro_torch.core.mtsl import TrainState, build_train_step, init_state
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import params_to_reference
from repro_torch.utils.device import generator
from repro_torch.utils.tree import tree_size


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="real mamba2-130m")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="/tmp/mtsl_lm.msgpack")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    if args.full:
        cfg = get_config("mamba2-130m").with_updates(
            num_clients=4, scan_layers=True, remat="none", dtype="float32")
    else:
        cfg = get_config("mamba2-130m").with_updates(
            num_layers=6, d_model=512, vocab_size=2048, ssm_chunk=64,
            num_clients=4, split_layers=2, scan_layers=False, remat="none",
            dtype="float32")
    if args.device == "cuda":  # f32 matmuls in full f32, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg)
    M = cfg.num_clients

    opt = adamw(args.lr)
    params = init_state(model, generator(args.device, 0), M)
    n_params = tree_size(params["towers"]) // M + tree_size(params["server"])
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params/client-view, "
          f"{M} clients)")
    state = TrainState(params, opt.init(params), 0)
    step_fn = build_train_step(model, opt, M)
    clr = lr_policy.server_scaled(M, server_scale=2.0 / M).to(args.device)

    src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=M,
                            beta=1.0, seed=0)
    floors = [src.entropy_floor(m) for m in range(M)]
    print("per-client entropy floors (nats):",
          " ".join(f"{f:.3f}" for f in floors))

    for i, batch in enumerate(client_batches(
            src, args.batch_per_client, seq_len=args.seq_len,
            steps=args.steps, seed=0)):
        state, metrics = step_fn(state, stage_batch(batch, args.device), clr)
        if (i + 1) % 20 == 0 or i == 0:
            per = metrics["per_task"].detach().cpu().numpy()
            gap = " ".join(f"{p - f:+.3f}" for p, f in zip(per, floors))
            print(f"step {i+1:>5d}  loss {float(metrics['loss']):.4f}  "
                  f"per-task gap-to-floor [{gap}]")
    save_checkpoint(args.checkpoint, {
        "params": params_to_reference(state.params, cfg),
        "step": int(state.step)})
    print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
