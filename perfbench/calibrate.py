"""The readings that a training cell's limits are set from (not run by the
benchmark's own runs):

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--program] [--control] [--witness] [--fault half] [--out FILE]

For each seed, in one process: the program's compared rounds held to the
float32 reference (--program); the control, the reference computed with
float8 (e4m3, per-tensor scales) in the program's place (--control); the
witness, the reference rounded to bfloat16 wherever the program holds
bf16, in the program's place (--witness); a planted fault in the
program's place (--fault half: each client's loss over half of its
positions). Each reading is one JSON line on standard output (and in
FILE), with `correct` as the cell's limits judge it and each number
compared beside its limit. For a mixture of experts the program's line
also carries the rows its dispatch kept and the rows routed over the
compared rounds (`moe_kept`, `moe_routed`).
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--fault", action="append", default=[], choices=("half",))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.lib import bench, result, weights
    from perfbench.lib import mtsl_train as drv
    from perfbench.lib.lm_data import MultiTaskLMSource, client_batches
    from perfbench.reference import train as reference

    w = bench.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    t = w["traffic_spec"]
    M, lr = t["num_clients"], t["lr"]
    dev = torch.device(args.device)
    limits = w["limits"]["limits"]

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        extra = {}
        if args.program:
            tally = _tally(w, torch, dev)
            p = drv.prepare(w, seed, dev)
            prog, first, spec = p.prog, p.first, p.spec
            if tally is not None:
                extra = dict(zip(("moe_kept", "moe_routed"), tally().tolist()))
            del p
            gc.collect()
            torch.cuda.empty_cache() if dev.type == "cuda" else None
        else:
            spec = weights.specs(w["cfg"], M)
            src = MultiTaskLMSource(t["data_vocab"], M, t["beta"], seed)
            first = list(itertools.islice(
                client_batches(src, t["batch_per_client"], t["seq_len"], seed),
                t["compared_steps"]))
        t1 = time.perf_counter()
        ref = reference.rounds(w["cfg"], spec, seed, first, lr, M, dev)
        t2 = time.perf_counter()
        runs = []
        if args.program:
            runs.append(("program", prog))
        for flag, prec in ((args.control, "fp8"), (args.witness, "bf16")):
            if flag:
                runs.append(("control" if prec == "fp8" else "witness", drv.as_program(
                    reference.rounds(w["cfg"], spec, seed, first, lr, M, dev, prec),
                    lr, M)))
        for fault in args.fault:
            runs.append((fault, drv.as_program(
                reference.rounds(w["cfg"], spec, seed, first, lr, M, dev, half=True),
                lr, M)))
        for mode, got in runs:
            numbers = drv.compare(got, ref, lr, M)
            correct, compared = result.judge(numbers, limits)
            rec = {"workload": args.workload, "seed": seed, "mode": mode,
                   "correct": correct, "numbers": numbers, "loss": got["loss"],
                   "ref_loss": ref["loss"], "program_s": t1 - t0, "reference_s": t2 - t1}
            if mode == "program":
                rec.update(extra)
            rec["compared"] = compared
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


def _tally(w: dict, torch, dev):
    """For a mixture of experts, start the program's dispatch tally and
    return a function that stops it and gives [kept, routed]; else None."""
    if w["cfg"]["family"] != "moe":
        return None
    from repro_torch.models.moe import moe_forward

    moe_forward.tally = torch.zeros(2, dtype=torch.int64, device=dev)

    def stop():
        got, moe_forward.tally = moe_forward.tally, None
        return got
    return stop


if __name__ == "__main__":
    sys.exit(main())
