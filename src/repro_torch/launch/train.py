"""Training launcher (port of `repro.launch.train`, on the paper
classifiers and the decoder LMs): trains any registered algorithm (mtsl,
splitfed, fedavg, fedprox, fedem, smofi, parallelsfl) on synthetic
heterogeneous data through the port's registry and loop, on CUDA unless
`--device cpu` is given.

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
    # a baseline, billed on an explicit edge graph (history "sim_time"):
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --arch paper-mlp --algorithm fedprox --local-steps 2 \
        --topology star --uplink-mbps 10

Algorithm hyper-parameters: `--hp key=value` sets any scalar HParams
field (e.g. `--hp num_components=4`, `--hp sample_weighted=true`);
`--prox-mu`, `--momentum` and `--num-clusters` are its deprecated aliases.
The baselines run the papers' plain local SGD at `--lr`. `--topology`
(star | clustered | hierarchical | multi-server, with per-link
`--uplink-mbps` / `--downlink-mbps` / `--backbone-mbps` /
`--link-latency-ms`) bills every round's traffic and reports the
simulated wall-clock.

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
them. The VLM and encoder-decoder archs are refused: their batches carry
vision features or audio frames beside the tokens, which the LM source
does not draw (the reference launcher cannot train them either; the
registry's round takes such batches). Not ported yet: `--mesh`,
`--client-chunk`, `--async` and `--sync-every` (the event engine and its
multi-server replica sync), `--data cached`, `--vectorized-data` and the
prefetch pipeline (`--prefetch`; the loop is synchronous, which the
reference guarantees gives the same trajectory).

`--checkpoint PATH` saves the algorithm's state every 100 rounds and after
the last one, in the reference's file format (train/checkpoint.py): the
reference's `load_algorithm_state` reads it, and so do the port's and
`repro_torch.launch.serve --checkpoint`.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import lr_policy
from repro_torch.core.algorithms import HParams, get_algorithm, list_algorithms
from repro_torch.core.schedule import ScheduleConfig, padded_batch_per_client
from repro_torch.core.topology import TOPOLOGIES, build_topology, mbps
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


def _coerce_hp(key: str, value: str):
    default = _HP_FIELDS[key]
    if isinstance(default, bool):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise argparse.ArgumentTypeError(
            f"--hp {key}= expects a boolean, got {value!r}")
    return type(default)(value)


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
            out[key] = _coerce_hp(key, value.strip())
        except (ValueError, argparse.ArgumentTypeError) as e:
            raise SystemExit(f"bad --hp {item!r}: {e}") from None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-mlp")
    ap.add_argument("--algorithm", default="mtsl", choices=list_algorithms())
    ap.add_argument("--steps", type=int, default=200,
                    help="total gradient steps (rounds x local-steps)")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="local steps per round for round-based FL algorithms")
    ap.add_argument("--hp", action="append", default=[], metavar="KEY=VALUE",
                    help="algorithm hyper-parameter override (repeatable); "
                         "any scalar HParams field, e.g. --hp prox_mu=0.1 "
                         "--hp sample_weighted=true")
    ap.add_argument("--prox-mu", type=float, default=None,
                    help="DEPRECATED alias for --hp prox_mu=...")
    ap.add_argument("--momentum", type=float, default=None,
                    help="DEPRECATED alias for --hp momentum=...")
    ap.add_argument("--num-clusters", type=int, default=None,
                    help="DEPRECATED alias for --hp num_clusters=...")
    ap.add_argument("--topology", default=None,
                    choices=[t.replace("_", "-") for t in TOPOLOGIES],
                    help="deploy on an explicit edge graph (core/topology.py)"
                         " and report the simulated wall-clock per round")
    ap.add_argument("--num-servers", type=int, default=2,
                    help="edge servers for clustered/hierarchical/"
                         "multi-server topologies")
    ap.add_argument("--uplink-mbps", type=float, default=None,
                    help="client->server bandwidth (default: infinite)")
    ap.add_argument("--downlink-mbps", type=float, default=None,
                    help="server->client bandwidth (default: infinite)")
    ap.add_argument("--backbone-mbps", type=float, default=None,
                    help="server<->server/core bandwidth (default: infinite)")
    ap.add_argument("--link-latency-ms", type=float, default=0.0,
                    help="one-way latency applied to every declared link")
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
    ap.add_argument("--checkpoint", default=None,
                    help="save the state here every 100 rounds and at the end")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)  # fail before building anything
    if dev.type == "cuda":  # f32 matmuls and convs in full f32, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    smoke = (not args.arch.startswith("paper-")) if args.smoke is None else args.smoke
    cfg = get_config(args.arch, smoke=smoke)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit(f"--arch {args.arch} ({cfg.family}): its batches carry "
                         f"{'vis' if cfg.family == 'vlm' else 'frames'} beside the "
                         "tokens, which the LM source does not draw (as in the "
                         "reference launcher); train it through the registry's "
                         "round with such a batch")
    is_classifier = cfg.family in ("mlp", "resnet")
    if args.num_clients is not None:
        cfg = cfg.with_updates(num_clients=args.num_clients)
    M = cfg.num_clients
    model = build_model(cfg)

    opt_name = args.optimizer or ("sgd" if is_classifier else "adamw")
    opt = sgd(args.lr) if opt_name == "sgd" else adamw(args.lr)
    alg = get_algorithm(args.algorithm)
    if not alg.uses_optimizer and opt_name != "sgd":
        print(f"note: {args.algorithm!r} runs the papers' plain local SGD at "
              f"--lr; --optimizer {opt_name} is ignored")
    scfg = ScheduleConfig(
        participation_rate=args.participation_rate,
        straggler_frac=args.straggler_frac,
        seed=args.seed if args.schedule_seed is None else args.schedule_seed,
        capability_batching=args.capability_batching,
        batch_boost=args.batch_boost)
    # --hp, with the per-algorithm flags as deprecated aliases (--hp wins)
    hp_overrides = parse_hp_overrides(args.hp)
    for flag, key in (("--prox-mu", "prox_mu"), ("--momentum", "momentum"),
                      ("--num-clusters", "num_clusters")):
        val = getattr(args, key)
        if val is not None:
            print(f"note: {flag} is deprecated; use --hp {key}={val}")
            hp_overrides.setdefault(key, val)
    topo = None
    if args.topology is not None:
        lat = args.link_latency_ms * 1e-3
        topo = build_topology(
            args.topology, M, num_servers=args.num_servers,
            uplink=mbps(args.uplink_mbps or 0.0, lat),
            downlink=mbps(args.downlink_mbps or 0.0, lat),
            backbone=mbps(args.backbone_mbps or 0.0, lat))
    spr = alg.steps_per_round(
        HParams(local_steps=args.local_steps).with_updates(**hp_overrides))
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
                       local_steps=args.local_steps, seed=args.seed,
                       hp_overrides=hp_overrides, schedule=scfg,
                       batch_per_client=args.batch_per_client, topology=topo,
                       device=args.device, checkpoint_path=args.checkpoint,
                       checkpoint_every=100 if args.checkpoint else 0)
    state, history = train(model, opt, batches, tcfg, M, component_lr=clr)
    print(f"final loss: {history[-1]['loss']:.4f}")
    if topo is not None:
        print(f"simulated wall-clock ({topo.name}): "
              f"{history[-1]['sim_time']:.2f}s over {history[-1]['round']} rounds")
    return state, history


if __name__ == "__main__":
    main()
