"""Quickstart on the PyTorch port (the twin of examples/quickstart.py):
MTSL vs FedAvg on heterogeneous multi-task data. Runs on the card unless
--device cpu; --steps 0.05 runs 5 % of the reference example's steps.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 0.05
"""
import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_runs import run, scaled, steps_scale  # noqa: E402


def main(argv=None, init=None):
    """`init`, when given, maps an algorithm's name to its initial state
    (the tests pass the reference's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=steps_scale, default=1.0,
                    help="fraction of the reference example's steps")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print("devices:", [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())])
    else:
        print("devices: [cpu]")
    print("\nTraining the paper's 4-layer MLP on maximally heterogeneous "
          "(alpha=0) synthetic multi-task data...\n")
    results = {}
    for alg in ["fedavg", "mtsl"]:
        steps = scaled(2000 if alg == "fedavg" else 400, args.steps)
        r = run("paper-mlp", alg, alpha=0.0, steps=steps, lr=0.1, local_steps=100,
                device=args.device, init_state=init(alg) if init else None)
        results[alg] = r
        print(f"  {alg:8s}: Accuracy_MTL = {r.acc_mtl:.3f}  ({r.wall_s:.1f}s)")
    print("\nMTSL keeps per-client towers private (no federation) and lets "
          "the shared server aggregate implicitly -> no client-drift collapse.")
    m, f = results["mtsl"], results["fedavg"]
    print(f"MTSL advantage: +{(m.acc_mtl - f.acc_mtl) * 100:.1f} accuracy points")
    return results


if __name__ == "__main__":
    main()
