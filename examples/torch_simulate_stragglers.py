"""Simulating stragglers and partial participation on the PyTorch port
(the twin of examples/simulate_stragglers.py): core/schedule.py at toy
scale.

Real edge deployments never get the textbook synchronous round: only a
subset of devices answers each round (participation sampling), and slow
devices finish fewer local steps than fast ones (stragglers). One object
models both:

    ScheduleConfig(participation_rate=0.5,  # each client answers a round
                                            # with probability 0.5
                   straggler_frac=0.5,      # half the clients are slow...
                   seed=7)                  # ...drawn reproducibly

Every round builder consumes the resulting per-round ClientSchedule
(mask + local-step budgets), and byte accounting bills only the clients
that talked. This script runs one algorithm under three regimes. The
reference example then drives the fig5 participation x straggler sweep
(benchmarks/fig5_participation.py); the port's sweep comes with the
port's benchmark, so this twin stops after the three regimes. Equivalent
launcher invocation:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-mlp \
        --algorithm mtsl --participation-rate 0.5 --straggler-frac 0.5

Runs on the card unless --device cpu:

    PYTHONPATH=src python examples/torch_simulate_stragglers.py
    PYTHONPATH=src python examples/torch_simulate_stragglers.py --device cpu --steps 0.5
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from repro_torch.core.schedule import ScheduleConfig  # noqa: E402
from torch_runs import run, scaled, steps_scale  # noqa: E402

REGIMES = [
    ("full sync          ", ScheduleConfig()),
    ("half participation ", ScheduleConfig(participation_rate=0.5, seed=7)),
    ("half part.+straggle", ScheduleConfig(participation_rate=0.5,
                                           straggler_frac=0.5, seed=7)),
]


def main(argv=None, init=None):
    """`init`, when given, maps an algorithm's name to its initial state
    (the tests pass the reference's). Returns {regime: Run}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=steps_scale, default=1.0,
                    help="fraction of the reference example's steps")
    args = ap.parse_args(argv)
    steps = scaled(60, args.steps)
    print(f"== one algorithm, three regimes (paper-mlp smoke, {steps} steps) ==")
    results = {}
    for label, scfg in REGIMES:
        r = run("paper-mlp", "mtsl", alpha=0.0, steps=steps, lr=0.1, smoke=True,
                eval_every=10, local_steps=1, batch_per_client=8, schedule=scfg,
                device=args.device, init_state=init("mtsl") if init else None)
        results[label.strip()] = r
        print(f"  {label}: acc_mtl={r.acc_mtl:.3f}  "
              f"MB={r.total_bytes / 1e6:.3f}  "
              f"avg participants={r.mean_participants:.1f}")
    return results


if __name__ == "__main__":
    main()
