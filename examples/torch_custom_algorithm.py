"""Add your own algorithm on the PyTorch port (the twin of
examples/custom_algorithm.py): register it, train it.

"local" is the no-communication baseline every FL paper compares against:
each client runs SGD on its own full model and NOTHING ever crosses the
network, so `round_bytes` is 0 and drift is maximal. One
`register_algorithm` call makes it drivable by `repro_torch.train.loop`,
`repro_torch.launch.train --algorithm local` (once this module is
imported) and checkpointing. Runs on the card unless --device cpu.

    PYTHONPATH=src python examples/torch_custom_algorithm.py
    PYTHONPATH=src python examples/torch_custom_algorithm.py --device cpu --steps 0.01
"""
import torch

from repro_torch.core import federation
from repro_torch.core.algorithms import (
    Algorithm, client_axes_by_keys, register_algorithm, split_local_steps)
from repro_torch.utils.tree import tree_map

# --- the ~30 lines -----------------------------------------------------------


def local_round(model, num_clients, hp):
    loss_fn = federation.full_model_loss(model)
    step = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    # round_fn takes (state, batch, schedule); "local" never communicates,
    # so participation masks have nothing to federate: a pure-local round
    # ignores the schedule (clients always train on their own data)
    def round_fn(state, batch, schedule=None):
        p = tree_map(torch.Tensor.detach,
                     {"tower": state["towers"], "server": state["servers"]})
        mbs = split_local_steps(batch, hp.local_steps)  # [M, k, b, ...]
        losses = []
        for t in range(hp.local_steps):
            grads, loss = step(p, {k: v[:, t] for k, v in mbs.items()})
            p = tree_map(lambda a, g: a - hp.lr * g.to(a.dtype), p, grads)
            losses.append(loss)
        losses = torch.stack(losses, 1).mean(1)
        new = {"towers": p["tower"], "servers": p["server"]}  # NO averaging
        return new, {"loss": losses.sum(), "per_task": losses}

    return round_fn


register_algorithm(Algorithm(
    name="local",
    init_state=lambda model, gen, M, hp: federation.init_fedavg_params(model, gen, M),
    round_fn=local_round,
    eval_fn=federation.eval_fedavg,  # same {"towers","servers"} state layout
    round_bytes=lambda cfg, M, b, hp, **kw: 0,  # nothing crosses the network
    # both state components are per-client [M, ...] rows (no averaging
    # ever mixes them): mesh sharding and the event engine treat every
    # row as client-owned
    client_axes=client_axes_by_keys("towers", "servers"),
    description="Local-only SGD per client, no communication.",
))

# --- done: every consumer layer can now drive it -----------------------------


def main(argv=None, init=None):
    """`init`, when given, maps an algorithm's name to its initial state
    (the tests pass the reference's)."""
    import argparse
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from torch_runs import run, scaled, steps_scale

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=steps_scale, default=1.0,
                    help="fraction of the reference example's steps")
    args = ap.parse_args(argv)
    print("Training 'local' (no communication) vs 'mtsl' on heterogeneous "
          "(alpha=0) synthetic multi-task data...\n")
    results = {}
    for alg in ["local", "mtsl"]:
        r = run("paper-mlp", alg, alpha=0.0, steps=scaled(400, args.steps), lr=0.1,
                local_steps=100, device=args.device,
                init_state=init(alg) if init else None)
        results[alg] = r
        print(f"  {alg:6s}: Accuracy_MTL = {r.acc_mtl:.3f}  "
              f"cumulative bytes to reach acc {r.bytes_to_acc}  ({r.wall_s:.1f}s)")
    print("\nLocal-only costs zero bytes but each client only ever sees its "
          "own task; MTSL shares the server and transfers across tasks.")
    return results


if __name__ == "__main__":
    main()
