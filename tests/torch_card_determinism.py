"""Whether the card's f32 resnet16 trajectories repeat: the measurement
behind running the card side of `chip_smoke.py`'s tparity and bparity
comparisons under deterministic algorithms (PERF.md, Findings).

    python3 tests/torch_card_determinism.py     # from the repo root, one GPU

Builds the kernels as `chip_smoke.py` does (TF32 off), then runs bparity's
SMoFi setting (full paper-resnet16, M = 10, b = 8, seed 3, lr 0.01, 2 local
steps, 3 rounds) on the card only, 4 times with PyTorch's defaults and 4
times under `torch.use_deterministic_algorithms(True, warn_only=True)`,
twice over, moving the allocator's state between runs. Prints each run's
losses, a hash of its final state and the ops flagged as lacking a
deterministic algorithm; then, per mode, the number of distinct final
states and each run's worst loss gap to the CPU's losses of the same
rounds. Then chip_smoke.py's tparity and bparity phases, twice each,
with their card losses.
"""
import hashlib
import itertools
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.schedule import (ScheduleConfig, capability_profile,
                                           schedule_stream)
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.device import generator

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs.build_phase()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = get_config("paper-resnet16")
    M, b, ls, rounds = cfg.num_clients, 8, 2, 3
    model = build_model(cfg)
    scfg = ScheduleConfig(participation_rate=0.5, straggler_frac=0.5, seed=3)
    hp = HParams(lr=0.01, local_steps=ls, capability=tuple(capability_profile(M, scfg)))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=3)
    batches = list(client_batches(src, b * ls, steps=rounds, seed=3))
    scheds = list(itertools.islice(schedule_stream(scfg, M, ls), rounds))
    alg = get_algorithm("smofi")
    init = alg.init_state(model, generator("cpu", 3), M, hp)

    def card_run():
        rf, st, losses = alg.round_fn(model, M, hp), cs._state_to(init, "cuda"), []
        for batch, sched in zip(batches, scheds):
            st, m = rf(st, stage_batch(batch, "cuda"), sched)
            losses.append(float(m["loss"]))
        h = hashlib.sha1()
        for _, v in sorted(cs._state_leaves(st).items()):
            h.update(v.detach().cpu().numpy().tobytes())
        return losses, h.hexdigest()[:12]

    res = {}
    for mode in ("default", "deterministic") * 2:
        runs = []
        for _ in range(4):
            if mode == "deterministic":
                with cs._deterministic(torch) as nondet:
                    run = card_run()
                runs.append(run + (nondet,))
            else:
                runs.append(card_run())
            # move the allocator's state between runs, as earlier phases do
            junk = torch.empty(int(torch.randint(1, 8, ()).item()) << 28,
                               dtype=torch.uint8, device="cuda")
            del junk
        print(mode, json.dumps(runs), flush=True)
        res.setdefault(mode, []).extend(runs)
    rf, st, cpu_losses = alg.round_fn(model, M, hp), cs._state_to(init, "cpu"), []
    for batch, sched in zip(batches, scheds):
        st, m = rf(st, stage_batch(batch, "cpu"), sched)
        cpu_losses.append(float(m["loss"]))
    print("cpu", json.dumps(cpu_losses), flush=True)
    for mode, runs in res.items():
        gaps = [max(abs(a - c) / c for a, c in zip(r[0], cpu_losses)) for r in runs]
        print(f"SUMMARY {mode}: {len({r[1] for r in runs})} distinct final states of "
              f"{len(runs)}; worst loss gap to the CPU per run {gaps}", flush=True)

    for i in range(2):
        t = time.perf_counter()
        tp = cs.train_parity_phase(torch)
        print(f"TPARITY {i} {time.perf_counter() - t:.1f} s "
              + json.dumps({k: tp[k] for k in ("lr0.01", "lr0.1")}), flush=True)
        t = time.perf_counter()
        bp = cs.baselines_parity_phase(torch)
        print(f"BPARITY {i} {time.perf_counter() - t:.1f} s " + json.dumps(
            {n: [(r["card_loss"], r["cpu_loss"]) for r in v["rounds"]]
             for n, v in bp["classifier"].items()}), flush=True)
        torch.cuda.empty_cache()
    print(f"done {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
