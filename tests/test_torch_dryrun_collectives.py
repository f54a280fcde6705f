"""The dry-run's collective tally (`utils.collectives`, over a client group
with no process group behind it) against a real gloo world of two ranks
at data=2: the same all-reduces and all-gathers, in calls and bytes, a
round per rank, for mtsl, splitfed and fedavg on smoke paper-mlp. The two
ranks come from `tests/torch_mesh_ranks.py`'s `rounds` task (the mesh
tests' spawn), which reports each cell's `collective_stats()`.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.launch.dryrun import run_program
from repro_torch.models.registry import build_model
from repro_torch.utils.collectives import count_op, top_collectives
from torch_mesh_ranks import spawn

M, B, ROUNDS, LR = 4, 8, 2, 0.1
ALGS = {"mtsl": 1, "splitfed": 2, "fedavg": 2}  # local steps
CFG = get_config("paper-mlp", smoke=True)


def _cell(alg, ls):
    rng = np.random.default_rng(0)
    spr = 1 if alg == "mtsl" else ls
    init = get_algorithm(alg).init_state(build_model(CFG), torch.Generator().manual_seed(0),
                                         M, HParams(lr=LR, local_steps=ls))
    batch = {"image": rng.normal(size=(M, B * spr, CFG.image_size, CFG.image_size))
             .astype(np.float32),
             "label": rng.integers(0, CFG.num_classes, size=(M, B * spr)).astype(np.int32)}
    return {"cfg": {"arch": "paper-mlp", "updates": {}}, "alg": alg, "M": M, "lr": LR,
            "local_steps": ls, "rounds": ROUNDS, "init": init, "batch": batch,
            "mesh": "data=2", "sched": ([1.0] * M, [ls] * M), "dense": False}


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    send, join = spawn(2, "rounds", tmp_path_factory.mktemp("dryrun_collectives"))
    send({"meshes": ("data=2",),
          "cells": {alg: _cell(alg, ls) for alg, ls in ALGS.items()}})
    return join()["cells"]


@pytest.mark.parametrize("alg", list(ALGS))
def test_dry_run_tally_equals_a_gloo_round(measured, alg):
    got = measured[alg]["collectives"]
    dry = run_program(build_model(CFG), "train", M, B, 0, shards=2, algorithm=alg,
                      lr=LR, local_steps=ALGS[alg], device="cpu")
    for kind, name in (("all_reduce", "all-reduce"), ("all_gather", "all-gather")):
        calls, nbytes = dry["collectives"].get(name, [0, 0])
        assert got[kind]["calls"] == ROUNDS * calls, (alg, kind, got, dry["collectives"])
        assert got[kind]["bytes"] == ROUNDS * nbytes, (alg, kind, got, dry["collectives"])
        assert count_op(dry["collective_ops"], name) == calls
    assert dry["collective_bytes"] == sum(v[1] for v in dry["collectives"].values()) > 0
    top = top_collectives(dry["collective_ops"], 1)
    assert top[0][2] == max(op.nbytes for op in dry["collective_ops"])
