"""Deploying the same training run on different edge topologies, on the
PyTorch port (the twin of examples/topology_walltime.py): a tour of
core/topology.py at toy scale.

    star(M)             the classic one-server deployment
    clustered(M, C)     ParallelSFL's C peer cluster servers + backbone
    hierarchical(M, C)  edge aggregators under one cloud root
    multi_server(M, S)  S peer servers that periodically sync; clients
                        attach to the nearest one

Each algorithm declares its round as per-link TrafficEvents, so one fold
bills the bytes and one model simulates the clock (per-client compute +
per-link bytes/bandwidth + latency, max over parallel paths, sum over
serial phases). This script runs mtsl vs fedavg vs parallelsfl on four
link regimes and prints simulated wall-clock to 70% Accuracy_MTL.
Equivalent launcher invocation:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-mlp \
        --topology multi-server --num-servers 2 --uplink-mbps 2 \
        --downlink-mbps 50 --link-latency-ms 5

Runs on the card unless --device cpu:

    PYTHONPATH=src python examples/torch_topology_walltime.py
    PYTHONPATH=src python examples/torch_topology_walltime.py --device cpu --steps 0.1
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.topology import clustered, mbps, multi_server, star  # noqa: E402
from torch_runs import run, scaled, steps_scale  # noqa: E402

ALGS = ("mtsl", "fedavg", "parallelsfl")


def regimes(M):
    return [
        ("ideal links      ", star(M)),
        ("slow uplink      ", star(M, uplink=mbps(2.0, 0.005),
                                   downlink=mbps(50.0, 0.005))),
        ("slow backbone    ", clustered(M, 2, uplink=mbps(20.0),
                                        downlink=mbps(20.0),
                                        backbone=mbps(1.0, 0.02))),
        ("2 synced servers ", multi_server(M, 2, uplink=mbps(10.0, 0.002),
                                           downlink=mbps(10.0, 0.002),
                                           backbone=mbps(5.0, 0.01))),
    ]


def main(argv=None, init=None):
    """`init`, when given, maps an algorithm's name to its initial state
    (the tests pass the reference's). Returns {(regime, algorithm): Run}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=steps_scale, default=1.0,
                    help="fraction of the reference example's steps")
    args = ap.parse_args(argv)
    M = get_config("paper-mlp", smoke=True).num_clients
    print("simulated seconds to 70% Accuracy_MTL (paper-mlp smoke):")
    print(f"  {'regime':<18} {'mtsl':>10} {'fedavg':>10} {'parallelsfl':>12}")
    results = {}
    for label, topo in regimes(M):
        cols = []
        for alg in ALGS:
            r = run("paper-mlp", alg, alpha=0.0, steps=scaled(200, args.steps),
                    smoke=True, lr=0.1, eval_every=2, local_steps=10,
                    batch_per_client=8, topology=topo, device=args.device,
                    init_state=init(alg) if init else None)
            results[(label.strip(), alg)] = r
            sim = r.sim_to_acc.get(0.7)
            cols.append(f"{sim:.3f}s" if sim is not None else "n/a")
        print(f"  {label:<18} {cols[0]:>10} {cols[1]:>10} {cols[2]:>12}")
    return results


if __name__ == "__main__":
    main()
