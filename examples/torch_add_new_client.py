"""The paper's add-a-new-client protocol (Table 3) on the PyTorch port
(the twin of examples/add_new_client.py): phase 1 trains M-1 clients;
phase 2 adds a new client and trains ONLY its tower (everything else
frozen via the component-LR mask), with no retraining of the federation,
a capability FL does not have. Runs on the card unless --device cpu;
--steps 0.01 runs 1 % of the reference example's steps.

    PYTHONPATH=src python examples/torch_add_new_client.py
    PYTHONPATH=src python examples/torch_add_new_client.py --device cpu --steps 0.01
"""
import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lr_policy  # noqa: E402
from repro_torch.core.mtsl import (  # noqa: E402
    TrainState, build_eval_step, build_train_step, init_state)
from repro_torch.core.split import client_freeze_lr  # noqa: E402
from repro_torch.data.pipeline import client_batches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train.loop import stage_batch  # noqa: E402
from repro_torch.utils.device import generator  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from torch_runs import make_source, scaled, steps_scale, test_batches  # noqa: E402


def main(argv=None, init=None):
    """`init`, when given, is the initial parameter tree (the tests pass
    the reference's). Returns the per-task accuracies after each phase
    and the largest move of the server's first leaf in phase 2."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=steps_scale, default=1.0,
                    help="fraction of the reference example's steps")
    args = ap.parse_args(argv)
    dev = args.device
    cfg = get_config("paper-mlp")
    model = build_model(cfg)
    M = cfg.num_clients
    new = M - 1
    src = make_source(cfg, alpha=0.0)
    tb = stage_batch(test_batches(cfg, src), dev)
    opt = sgd(0.1)
    params = init if init is not None else init_state(model, generator(dev, 0), M)
    state = TrainState(params, opt.init(params), 0)
    step_fn = build_train_step(model, opt, M)
    ev = build_eval_step(model, M)

    print(f"phase 1: training {M-1} clients (client {new} held out)...")
    clr1 = lr_policy.server_scaled(M, 2.0 / M).to(dev)
    for batch in client_batches(src, 16, steps=scaled(400, args.steps), seed=1):
        for k in batch:  # the held-out slot sees a neighbour's data
            batch[k][new] = batch[k][0]
        state, _ = step_fn(state, stage_batch(batch, dev), clr1)
    acc1 = ev(state.params, tb)["per_task_acc"].cpu().numpy()
    print(f"  per-task acc: {np.round(acc1, 2)}")
    print(f"  held-out client {new}: {float(acc1[new]):.2f}")

    print(f"phase 2: adding client {new}; ONLY its tower trains "
          f"(server + other towers frozen)...")
    clr2 = client_freeze_lr(M, new).to(dev)
    server_before = tree_leaves(state.params["server"])[0].detach().clone()
    for batch in client_batches(src, 16, steps=scaled(200, args.steps), seed=2):
        state, _ = step_fn(state, stage_batch(batch, dev), clr2)
    moved = float((tree_leaves(state.params["server"])[0].detach() - server_before).abs().max())
    acc2 = ev(state.params, tb)["per_task_acc"].cpu().numpy()
    print(f"  per-task acc: {np.round(acc2, 2)}")
    print(f"  new client now: {float(acc2[new]):.2f}  "
          f"(server params moved: {moved:.1e})")
    print(f"  Accuracy_MTL = {float(np.mean(acc2)):.3f}")
    return {"acc1": acc1, "acc2": acc2, "server_moved": moved}


if __name__ == "__main__":
    main()
