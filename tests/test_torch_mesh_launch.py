"""The port's `--mesh` through the launcher and the train loop, on gloo CPU
ranks:

  * `python -m repro_torch.launch.train --device cpu --smoke --mesh data=2`
    (M = 4) starts its two ranks itself and logs the same losses as the
    run without `--mesh`; its checkpoint (the gathered state, written by
    the first rank) holds the same state within 1e-5;
  * `train(mesh=)` on data=2 (tests/torch_mesh_ranks.py `ckpt_task`; mtsl,
    a heterogeneous schedule, eval every 3 rounds): against the same run
    without a mesh, history (losses, participants, evals) and final state
    within 1e-5; a sharded run checkpointed at round 3 and resumed from
    its file equals the uninterrupted sharded run bit for bit; a sharded
    run resumed from an unsharded run's checkpoint, and an unsharded run
    resumed from a sharded run's checkpoint, each match the uninterrupted
    runs within 1e-5; the reference's `train/checkpoint.py` reads the
    sharded run's file (the same leaves as the port's reader); each rank
    reading its clients (`subset`) of a cached dataset trains as the unsharded run
    on the whole cache;
  * the launcher's refusals against the reference's messages: a mesh
    whose client shards do not divide M, `--async` with `--mesh`, a
    malformed spec.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.launch.train as jax_launch
import repro_torch.launch.train as launch
from repro.train import checkpoint as jax_checkpoint
from repro_torch.data import shards
from repro_torch.train.checkpoint import load_algorithm_state
from repro_torch.utils.convert import state_from_jax
from torch_mesh_ranks import _setup, flat_state, max_gap, run_train, spawn

ROOT = Path(__file__).resolve().parent.parent
P = {"M": 4, "b": 4, "lr": 0.1, "rounds": 6, "cut": 3}
TOL = 1e-5
LAUNCH = ["--device", "cpu", "--smoke", "--num-clients", "4", "--steps", "6"]


def _launcher(extra, ckpt):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                             *LAUNCH, *extra, "--checkpoint", str(ckpt)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher twice (subprocesses) and the ckpt task's ranks, all at
    once; the unsharded runs in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh_launch")
    procs = {k: _launcher(flags, tmp / f"{k}.msgpack")
             for k, flags in (("dense", []), ("mesh", ["--mesh", "data=2"]))}
    send, join = spawn(2, "ckpt", tmp)
    p = {**P, **{k: str(tmp / f"{k}.msgpack")
                 for k in ("sharded_full", "sharded_cut", "dense_cut")},
         "cache": str(tmp / "cache")}
    run_train(P, None, P["cut"], path=p["dense_cut"])
    send(p)
    dense = run_train(P, None, P["rounds"])
    out = {"dense": (dense[1], flat_state(dense[0])), "paths": p}
    cfg = _setup(P)[0]
    out["ranks"] = join()
    init, _, extra = load_algorithm_state(p["sharded_cut"], "mtsl", cfg=cfg)
    s, h = run_train(P, None, P["rounds"], init=init, start=extra["round"])
    out["dense_from_sharded"] = (h, flat_state(s))
    s, h = run_train(P, None, P["rounds"], source=shards.load_cache(p["cache"]))
    out["dense_cached"] = (h, flat_state(s))
    out["launch"] = {}
    for k, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (k, stdout[-2000:], stderr[-4000:])
        state, name, ext = load_algorithm_state(str(tmp / f"{k}.msgpack"), cfg=cfg)
        out["launch"][k] = (stdout, flat_state(state), name, ext)
    return out


def _same_history(got, want, exact=False):
    assert [e["round"] for e in got] == [e["round"] for e in want]
    for a, b in zip(got, want):
        assert a["participants"] == b["participants"]
        for k in ("loss", "acc_mtl"):
            assert (k in a) == (k in b)
            if k in a:
                if exact:
                    assert a[k] == b[k], (k, a, b)
                else:
                    assert abs(a[k] - b[k]) <= TOL * max(1.0, abs(b[k])), (k, a, b)


def test_launcher_mesh_matches_unsharded(runs):
    (d_out, d_state, d_name, d_ext), (m_out, m_state, m_name, m_ext) = (
        runs["launch"]["dense"], runs["launch"]["mesh"])
    assert "mesh data=2: 2 rank(s) over gloo (on the CPU)" in m_out
    steps = re.compile(r"^step .*$", re.M)
    # the logged losses (4 decimals) and the final line, once each
    assert [ln.split("(")[0] for ln in steps.findall(m_out)] == \
        [ln.split("(")[0] for ln in steps.findall(d_out)]
    assert m_out.count("final loss:") == 1
    assert d_out.split("final loss:")[1] == m_out.split("final loss:")[1]
    assert (m_name, m_ext) == (d_name, d_ext) == ("mtsl", {"step": 6, "round": 6})
    assert max_gap(m_state, d_state) <= TOL


def test_sharded_train_matches_unsharded(runs):
    h, state = runs["ranks"]["full"]
    dh, dstate = runs["dense"]
    _same_history(h, dh)
    assert any("acc_mtl" in e for e in h)
    assert max_gap(state, dstate) <= TOL


def test_sharded_resume_is_bit_equal(runs):
    h_full, s_full = runs["ranks"]["full"]
    h_res, s_res = runs["ranks"]["resumed"]
    _same_history(h_res, h_full, exact=True)
    assert max_gap(s_res, s_full) == 0.0


def test_checkpoints_cross_between_sharded_and_unsharded(runs):
    dh, dstate = runs["dense"]
    cut = P["cut"]
    # a sharded run resumed from the unsharded run's file
    h, s = runs["ranks"]["from_dense"]
    _same_history(h, [e for e in dh if e["round"] > cut])
    assert max_gap(s, dstate) <= TOL
    # an unsharded run resumed from the sharded run's file
    h, s = runs["dense_from_sharded"]
    _same_history(h, [e for e in dh if e["round"] > cut])
    assert max_gap(s, dstate) <= TOL


def test_reference_reads_the_sharded_checkpoint(runs):
    cfg = _setup(P)[0]
    for key, rounds in (("sharded_cut", P["cut"]), ("sharded_full", P["rounds"])):
        path = runs["paths"][key]
        state_j, name, extra = jax_checkpoint.load_algorithm_state(path, "mtsl")
        assert name == "mtsl" and extra == {"step": rounds, "round": rounds}
        mine, _, _ = load_algorithm_state(path, "mtsl", cfg=cfg)
        theirs = state_from_jax("mtsl", state_j, "cpu", cfg)
        assert max_gap(flat_state(theirs), flat_state(mine)) == 0.0
    assert max_gap(flat_state(mine), runs["ranks"]["full"][1]) == 0.0


def test_cached_blocks_match_the_whole_cache(runs):
    h, s = runs["ranks"]["cached"]
    dh, ds = runs["dense_cached"]
    _same_history(h, dh)
    assert max_gap(s, ds) <= TOL


@pytest.mark.parametrize("argv,match", [
    (["--num-clients", "4", "--mesh", "data=3"], "which must divide the client count"),
    (["--num-clients", "4", "--mesh", "data=2", "--async"], "--async is incompatible"),
    (["--num-clients", "8", "--mesh", "pod=2,data=3"], "shards the client axis 6 ways"),
])
def test_launcher_refusals_match_reference(argv, match):
    msgs = []
    for module, base in ((jax_launch, ["--smoke"]),
                         (launch, ["--smoke", "--device", "cpu"])):
        with pytest.raises(SystemExit, match=match) as e:
            module.main(base + argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(SystemExit, match="must be '<axis>=<positive int>'"):
        launch.main(["--smoke", "--device", "cpu", "--mesh", "data=two"])
