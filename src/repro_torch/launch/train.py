"""Training launcher (port of `repro.launch.train`, the mtsl path on the
paper classifiers and the decoder LMs): trains on synthetic heterogeneous
data through the port's registry and loop, on CUDA unless `--device cpu`
is given.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 8
    # the paper's ResNet-16 at full width and depth on one card, M = 10:
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-resnet16 \
        --algorithm mtsl --steps 200 --batch-per-client 8 --lr 0.1
    # an LM (smoke config unless --no-smoke), next-token CE on per-client
    # Markov chains (data/lm.py):
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch zamba2-7b --steps 3 --seq-len 32

The reference's defaults hold: paper configs are full size unless
`--smoke`, every other arch takes its smoke config unless `--no-smoke`
(the reference launcher cannot leave them); one task per class
(num_classes = M) unless `--num-clients` is given; the optimizer is sgd
for the classifiers and adamw for the LMs unless `--optimizer`; LM data
come from `MultiTaskLMSource(vocab_size=cfg.vocab_size, beta=1 - alpha)`
at `--seq-len` (default 256); the server LR multiplier is
`--server-lr-scale` (default 1/M, the launcher's `server_scaled` policy;
`train()` without a component LR falls back to 2/M). On CUDA, f32 matmuls
and convolutions run in full f32 (TF32 off), as the reference computes
them. Not ported yet: the MoE, VLM and encoder-decoder archs, the six
baselines, `--mesh`, `--client-chunk`, `--async`, `--topology`, `--data
cached`, `--checkpoint`, `--vectorized-data` and the prefetch pipeline
(`--prefetch`; the loop is synchronous, which the reference guarantees
gives the same trajectory).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import lr_policy
from repro_torch.core.algorithms import HParams, get_algorithm, list_algorithms
from repro_torch.core.schedule import ScheduleConfig, padded_batch_per_client
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.train.loop import TrainConfig, train
from repro_torch.utils.device import resolve_device

# scalar HParams fields settable via --hp key=value
_HP_FIELDS = {
    f.name: f.default
    for f in dataclasses.fields(HParams)
    if isinstance(f.default, (bool, int, float))
}


def parse_hp_overrides(items) -> dict:
    """['key=value', ...] -> validated HParams override dict."""
    out = {}
    for item in items:
        key, sep, value = item.partition("=")
        key = key.strip().replace("-", "_")
        if not sep:
            raise SystemExit(f"--hp expects key=value, got {item!r}")
        if key not in _HP_FIELDS:
            raise SystemExit(f"unknown hyper-parameter {key!r}; --hp accepts: "
                             f"{', '.join(sorted(_HP_FIELDS))}")
        try:
            out[key] = type(_HP_FIELDS[key])(value.strip())
        except ValueError as e:
            raise SystemExit(f"bad --hp {item!r}: {e}") from None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-mlp")
    ap.add_argument("--algorithm", default="mtsl", choices=list_algorithms())
    ap.add_argument("--steps", type=int, default=200,
                    help="total gradient steps (rounds x local-steps)")
    ap.add_argument("--hp", action="append", default=[], metavar="KEY=VALUE",
                    help="algorithm hyper-parameter override (repeatable), "
                         "e.g. --hp microbatches=2")
    ap.add_argument("--participation-rate", type=float, default=1.0,
                    help="per-round client participation probability "
                         "(1.0 = classic full synchronous rounds)")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of clients that are slow devices")
    ap.add_argument("--schedule-seed", type=int, default=None,
                    help="seed for the participation/straggler stream "
                         "(default: --seed)")
    ap.add_argument("--capability-batching", action="store_true",
                    help="capability-aware local batch sizing: slow clients "
                         "get proportionally smaller per-step batches (round "
                         "total conserved); see core/schedule.py")
    ap.add_argument("--batch-boost", type=float, default=2.0,
                    help="padded-row headroom for capability batching")
    ap.add_argument("--num-clients", type=int, default=None,
                    help="override the arch config's M (the task count then "
                         "decouples from the class count: task m's main "
                         "class is m %% num_classes)")
    ap.add_argument("--batch-per-client", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--alpha", type=float, default=0.0, help="heterogeneity")
    ap.add_argument("--noise-sigma", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--server-lr-scale", type=float, default=None)
    ap.add_argument("--optimizer", default=None, choices=[None, "sgd", "adamw"])
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="use the reduced config (default: off for the paper-* "
                         "archs, on for every other arch, as the reference "
                         "launcher; --no-smoke reaches the full config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)  # fail before building anything
    if dev.type == "cuda":  # f32 matmuls and convs in full f32, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    smoke = (not args.arch.startswith("paper-")) if args.smoke is None else args.smoke
    cfg = get_config(args.arch, smoke=smoke)
    if cfg.family not in ("mlp", "resnet", "dense", "ssm", "hybrid"):
        raise SystemExit(f"--arch {args.arch} ({cfg.family}): only the paper "
                         "classifiers' and the dense / ssm / hybrid LMs' "
                         "training is ported yet")
    is_classifier = cfg.family in ("mlp", "resnet")
    if args.num_clients is not None:
        cfg = cfg.with_updates(num_clients=args.num_clients)
    M = cfg.num_clients
    model = build_model(cfg)

    opt_name = args.optimizer or ("sgd" if is_classifier else "adamw")
    opt = sgd(args.lr) if opt_name == "sgd" else adamw(args.lr)
    alg = get_algorithm(args.algorithm)
    scfg = ScheduleConfig(
        participation_rate=args.participation_rate,
        straggler_frac=args.straggler_frac,
        seed=args.seed if args.schedule_seed is None else args.schedule_seed,
        capability_batching=args.capability_batching,
        batch_boost=args.batch_boost)
    hp_overrides = parse_hp_overrides(args.hp)
    spr = alg.steps_per_round(HParams().with_updates(**hp_overrides))
    # capability batching pads the generated rows so fast clients have
    # headroom; the nominal per-step batch still sets the round total
    per_round_batch = padded_batch_per_client(scfg, args.batch_per_client) * spr
    # the paper ties one task to one class (num_classes == M); an explicit
    # --num-clients decouples them via num_tasks
    if is_classifier:
        src = MultiTaskImageSource(
            num_classes=M if args.num_clients is None else cfg.num_classes,
            num_tasks=None if args.num_clients is None else M,
            image_size=cfg.image_size, channels=cfg.image_channels,
            alpha=args.alpha, noise_sigma=args.noise_sigma, seed=args.seed)
    else:
        src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=M,
                                beta=1.0 - args.alpha, seed=args.seed)
    batches = client_batches(src, per_round_batch, seed=args.seed,
                             seq_len=None if is_classifier else args.seq_len)

    clr = lr_policy.server_scaled(M, args.server_lr_scale)  # Eq. 9: 1/M
    tcfg = TrainConfig(steps=args.steps, algorithm=args.algorithm, lr=args.lr,
                       seed=args.seed,
                       hp_overrides=hp_overrides, schedule=scfg,
                       batch_per_client=args.batch_per_client,
                       device=args.device)
    state, history = train(model, opt, batches, tcfg, M, component_lr=clr)
    print(f"final loss: {history[-1]['loss']:.4f}")
    return state, history


if __name__ == "__main__":
    main()
