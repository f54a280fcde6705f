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
registry's round takes such batches).

The training loop's systems layers, with the reference's flags, defaults
and refusals:

  * `--prefetch N` (default 2): the async round pipeline
    (train/pipeline.py): schedules and batches drawn N rounds ahead on a
    background thread, copied to the card on a side stream, metrics read
    lazily. 0 = synchronous; the trajectory is the same at any depth.
  * `--async` (train/events.py): the staleness-aware event engine instead
    of the round barrier, with `--staleness-decay`, `--max-staleness` and,
    on `--topology multi-server`, replica syncs every `--sync-every`
    rounds. `--sim-ms-per-sample` sets the simulated client compute.
  * `--data cached --cache-dir D` (data/shards.py): deterministic mmap'd
    shard reads from an on-disk client cache, built on first use
    (`--cache-examples` per client; `--dirichlet-alpha A` builds it as a
    Dirichlet(A) partition of a pooled corpus). Caches are byte-identical
    to the reference's, so either package reads the other's.
    `--vectorized-data` draws synthetic rounds with one batched RNG pass.
  * `--client-chunk C` (core/client_axis.py): every round over blocks of C
    clients, each block's backward before the next; C must divide M and
    `--async` refuses it.
  * `--mesh data=N[,model=K[,pod=P]]` (launch/mesh.py, utils/sharding.py):
    the client axis over N·K·P = D ranks, one process per mesh position:
    each rank holds M/(N·P) clients (towers, per-client optimizer state,
    schedule rows, its rows of each round and eval batch; a cached dataset
    reads only its clients), the rest is replicated, and the federation
    means and server-gradient sums are all-reduces over the client group.
    Which clients: without `--client-chunk` the rank's contiguous block;
    with `--client-chunk C` its C/D clients of each chunk {j·C + r·C/D +
    i} (utils/sharding.py `rank_rows`), so the ranks' parts of chunk j are
    clients [j·C, (j+1)·C), the reference's chunk, and an MoE's expert
    capacity is the chunk's, as the reference's (`--mesh data=2
    --client-chunk 2` on deepseek-moe-16b). Ranks that differ only in
    "model" compute the same round. M must divide by N·P, a
    `--client-chunk` must be a multiple of it, and `--async` refuses a
    mesh. A plain launch starts the ranks itself
    (spawned processes, a file rendezvous in a temporary directory); under
    `torchrun --nproc-per-node N·K·P` it uses the ranks it was given. Rank
    r runs on `cuda:(r % device_count)`, or on the CPU under
    `--device cpu`. The backend, printed by the first rank: NCCL when
    every rank has a card of its own, gloo when ranks share a card (NCCL
    refuses two ranks on one card) or on the CPU. The first rank logs and
    writes the checkpoint (the whole state, gathered).

`--checkpoint PATH` saves the algorithm's state every 100 rounds and after
the last one, in the reference's file format (train/checkpoint.py): the
reference's `load_algorithm_state` reads it, and so do the port's and
`repro_torch.launch.serve --checkpoint`.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import shutil
import sys
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import lr_policy
from repro_torch.core.algorithms import (
    HParams,
    get_algorithm,
    list_algorithms,
    num_rounds,
)
from repro_torch.core.schedule import ScheduleConfig, padded_batch_per_client
from repro_torch.core.topology import TOPOLOGIES, build_topology, mbps
from repro_torch.data import shards
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.launch.mesh import make_mesh_from_spec, mesh_size, parse_mesh_spec
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.train.loop import TrainConfig, train
from repro_torch.utils.device import resolve_device
from repro_torch.utils.sharding import client_group

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


def _cached_dataset(args, src, M, is_classifier):
    """Open (or build once) the on-disk client cache for --data cached."""
    if not args.cache_dir:
        raise SystemExit("--data cached requires --cache-dir")
    seq = None if is_classifier else args.seq_len
    try:
        ds = shards.load_cache(args.cache_dir)
    except FileNotFoundError:
        if args.dirichlet_alpha is not None:
            # the standard non-IID protocol: pool an IID corpus, then
            # Dirichlet(alpha)-partition it across the M clients
            corpus = shards.pooled_corpus(src, M * args.cache_examples,
                                          seed=args.seed, seq_len=seq)
            shards.build_dirichlet_cache(args.cache_dir, corpus, M,
                                         args.dirichlet_alpha, seed=args.seed)
        else:
            shards.build_cache(args.cache_dir, src, args.cache_examples,
                               seq_len=seq, seed=args.seed)
        print(f"built client cache at {args.cache_dir}")
        ds = shards.load_cache(args.cache_dir)
    if ds.num_clients_total != M:
        raise SystemExit(
            f"cache at {args.cache_dir!r} holds {ds.num_clients_total} "
            f"clients but the run needs {M} (rebuild with "
            f"tools/cache_dataset.py or point --cache-dir elsewhere)")
    want_kind = "image" if is_classifier else "lm"
    if ds.kind != want_kind:
        raise SystemExit(
            f"cache at {args.cache_dir!r} is kind {ds.kind!r} but --arch "
            f"needs {want_kind!r}")
    if seq is not None and ds.seq_len is not None and seq > ds.seq_len:
        raise SystemExit(
            f"--seq-len {seq} exceeds the cached sequence length "
            f"{ds.seq_len} at {args.cache_dir!r}")
    return ds


def pick_backend(device_type: str, world: int) -> tuple:
    """(backend, why) for `world` ranks on `device_type`: NCCL when every
    rank has a card of its own; gloo when ranks share a card (NCCL refuses
    two ranks on one card; on CUDA tensors gloo carries all_reduce and
    broadcast, and the port's gathers go through the host) or on the
    CPU."""
    if device_type != "cuda":
        return "gloo", "on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} rank(s) on {cards} card(s), one each"
    return "gloo", f"{world} ranks share {cards} card(s)"


def init_distributed(device_type: str, rank: int, world: int,
                     init_method: str = "env://") -> str:
    """Join the world as `rank` of `world` over pick_backend's backend (on
    the card, rank r uses cuda:(r % device_count)). Returns "<world>
    rank(s) over <backend> (<why>)"."""
    import torch.distributed as dist

    backend, why = pick_backend(device_type, world)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    return f"{world} rank(s) over {backend} ({why})"


def _rank_main(rank: int, argv, world: int, init_method: str, device_type: str):
    """One spawned rank: join the world, run the launcher, leave."""
    import torch.distributed as dist

    init_distributed(device_type, rank, world, init_method)
    try:
        main(argv)
    finally:
        dist.destroy_process_group()


def spawn_ranks(argv, world: int, device_type: str) -> None:
    """Run `main(argv)` on `world` spawned ranks (a file rendezvous in a
    temporary directory, removed after), and wait for them."""
    import torch.multiprocessing as mp

    folder = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        mp.start_processes(_rank_main, args=(argv, world,
                                             f"file://{folder}/rendezvous",
                                             device_type),
                           nprocs=world, start_method="spawn")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


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
    ap.add_argument("--sync-every", type=int, default=1,
                    help="multi-server replica sync period, in rounds")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="event-driven asynchronous execution "
                         "(train/events.py): replace the synchronous round "
                         "barrier with the staleness-aware event-queue "
                         "engine — fast clients keep cycling while "
                         "stragglers' updates arrive late and merge "
                         "down-weighted by staleness")
    ap.add_argument("--staleness-decay", type=float, default=1.0,
                    help="async staleness decay: an update dispatched s "
                         "server applies ago merges with weight decay**s "
                         "(1.0 = no down-weighting)")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="async: drop updates staler than this many server "
                         "applies (default: keep all)")
    ap.add_argument("--sim-ms-per-sample", type=float, default=1.0,
                    help="simulated client compute per sample at capability "
                         "1.0 (the walltime model's compute unit)")
    ap.add_argument("--participation-rate", type=float, default=1.0,
                    help="per-round client participation probability "
                         "(1.0 = classic full synchronous rounds)")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of clients that are slow devices")
    ap.add_argument("--schedule-seed", type=int, default=None,
                    help="seed for the participation/straggler stream "
                         "(default: --seed)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="async round pipeline depth (train/pipeline.py): "
                         "schedules/batches for this many rounds are drawn "
                         "on a background thread and staged on the card "
                         "while the current round runs, and metrics are "
                         "read back lazily. 0 = fully synchronous (the "
                         "trajectory is identical either way)")
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
    ap.add_argument("--mesh", default=None, metavar="data=N[,model=K[,pod=P]]",
                    help="shard the client axis over a mesh of ranks "
                         "(launch/mesh.py): client leaves split over the "
                         "pod x data ranks, the rest replicated; starts "
                         "the ranks itself unless run under torchrun")
    ap.add_argument("--client-chunk", type=int, default=None,
                    help="client-block size: rounds process the client axis "
                         "in blocks of this many clients (each block's "
                         "backward before the next), so live activations "
                         "stay one block's as the client count grows; must "
                         "divide num-clients")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "cached"],
                    help="data path: 'synthetic' re-synthesizes every "
                         "round's batch on the host; 'cached' reads "
                         "deterministic mmap'd shards from --cache-dir "
                         "(data/shards.py — built on first use if missing)")
    ap.add_argument("--cache-dir", default=None,
                    help="cache directory for --data cached")
    ap.add_argument("--dirichlet-alpha", type=float, default=None,
                    help="with --data cached: build the cache as a "
                         "Dirichlet(alpha) non-IID partition of a pooled "
                         "corpus instead of per-client streams; small "
                         "alpha = near-disjoint client label distributions")
    ap.add_argument("--cache-examples", type=int, default=512,
                    help="examples per client materialized when the cache "
                         "is built on first use (--data cached)")
    ap.add_argument("--vectorized-data", action="store_true",
                    help="draw each round's synthetic batch with ONE batched "
                         "numpy RNG pass across all clients (host cost per "
                         "client flat in M) instead of the per-client loop; "
                         "same distribution, different seeded stream")
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
    # refuse before paying for the model build or data synthesis
    if args.client_chunk is not None and M % args.client_chunk != 0:
        raise SystemExit(
            f"--client-chunk {args.client_chunk} must divide the client "
            f"count: {M} % {args.client_chunk} != 0 (pick a chunk that "
            f"divides num-clients, or adjust --num-clients)")
    if args.mesh:
        try:
            sizes = parse_mesh_spec(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh!r}: {e}") from None
        shards = sizes.get("pod", 1) * sizes.get("data", 1)
        if shards > 1 and M % shards != 0:
            raise SystemExit(
                f"--mesh {args.mesh!r} shards the client axis {shards} "
                f"ways, which must divide the client count: {M} % {shards} "
                f"!= 0 (adjust --num-clients or the data/pod axis sizes)")
    if args.async_mode and (args.mesh or args.client_chunk is not None):
        raise SystemExit(
            "--async is incompatible with --mesh/--client-chunk: the event "
            "engine dispatches host-driven cohorts, not one sharded round "
            "program")
    mesh = group = None
    if args.mesh:
        import torch.distributed as dist

        if not dist.is_initialized():
            if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
                spawn_ranks(sys.argv[1:] if argv is None else list(argv),
                            mesh_size(args.mesh), dev.type)
                return None
            # under torchrun: the ranks it was given
            init_distributed(dev.type, int(os.environ["RANK"]),
                             int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh_from_spec(args.mesh, device_type=dev.type)
        group = client_group(mesh)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        if dist.get_rank() == 0:
            world = dist.get_world_size()
            print(f"mesh {args.mesh}: {world} rank(s) over {dist.get_backend()} "
                  f"({pick_backend(dev.type, world)[1]})", flush=True)
    first = group is None or dist.get_rank() == 0
    model = build_model(cfg)

    opt_name = args.optimizer or ("sgd" if is_classifier else "adamw")
    opt = sgd(args.lr) if opt_name == "sgd" else adamw(args.lr)
    alg = get_algorithm(args.algorithm)
    if not alg.uses_optimizer and opt_name != "sgd" and first:
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
            if first:
                print(f"note: {flag} is deprecated; use --hp {key}={val}")
            hp_overrides.setdefault(key, val)
    topo = None
    if args.topology is not None:
        lat = args.link_latency_ms * 1e-3
        topo = build_topology(
            args.topology, M, num_servers=args.num_servers,
            uplink=mbps(args.uplink_mbps or 0.0, lat),
            downlink=mbps(args.downlink_mbps or 0.0, lat),
            backbone=mbps(args.backbone_mbps or 0.0, lat),
            sync_every=args.sync_every)
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
    rounds = num_rounds(args.steps, spr)
    seq = None if is_classifier else args.seq_len
    if args.data == "cached":
        # cached shard READS replace per-round synthesis on the prefetch
        # thread (data/shards.py); the cache is built once on first use (by
        # the first rank under a mesh; each rank then reads its clients)
        if first:
            ds = _cached_dataset(args, src, M, is_classifier)
        if group is not None:
            dist.barrier()
            if not first:
                ds = _cached_dataset(args, src, M, is_classifier)
            ds = ds.subset(group.rows(M, args.client_chunk))
        batches = client_batches(ds, per_round_batch, steps=rounds, seq_len=seq,
                                 seed=args.seed)
    else:
        batches = client_batches(src, per_round_batch, steps=rounds, seq_len=seq,
                                 seed=args.seed, vectorized=args.vectorized_data)

    clr = lr_policy.server_scaled(M, args.server_lr_scale)  # Eq. 9: 1/M
    tcfg = TrainConfig(steps=args.steps, algorithm=args.algorithm, lr=args.lr,
                       local_steps=args.local_steps, seed=args.seed,
                       hp_overrides=hp_overrides, schedule=scfg,
                       batch_per_client=args.batch_per_client, topology=topo,
                       device=str(dev), checkpoint_path=args.checkpoint,
                       checkpoint_every=100 if args.checkpoint else 0,
                       prefetch=args.prefetch,
                       time_per_sample_s=args.sim_ms_per_sample * 1e-3,
                       client_chunk=args.client_chunk,
                       async_mode=args.async_mode,
                       staleness_decay=args.staleness_decay,
                       max_staleness=args.max_staleness, mesh=mesh)
    state, history = train(model, opt, batches, tcfg, M, component_lr=clr)
    if not first:
        return state, history
    print(f"final loss: {history[-1]['loss']:.4f}")
    if history and (topo is not None or args.async_mode):
        t = topo.name if topo is not None else "star"
        unit = "applies" if args.async_mode else "rounds"
        print(f"simulated wall-clock ({t}"
              + (", async" if args.async_mode else "")
              + f"): {history[-1]['sim_time']:.2f}s over "
              f"{history[-1]['round']} {unit}")
    return state, history


if __name__ == "__main__":
    main()
