"""The baselines through the port's launcher and loop against the
reference's, with the simulated clock.

The launcher: `repro_torch.launch.train.main([... --device cpu])` against
`repro.launch.train.main([... --prefetch 0])` with the same argv, a fedprox
run billed on a star topology with a 10 Mb/s uplink. The reference draws
its state with jax.random, which torch cannot reproduce, so both
registries' fedprox `init_state` return one initial state: the reference's
draw, carried across with `state_from_jax`. The histories must agree entry
for entry: step, round and participants exactly, the loss within 1e-5,
and `sim_time` equal (it is host arithmetic on the same byte counts and
schedules). The loop: splitfed on a multi-server topology under a
straggler schedule, and parallelsfl under capability batching on a
clustered one, the same way."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.core import topology as jax_topo
from repro.data.pipeline import client_batches as jax_client_batches
from repro.data.synthetic import MultiTaskImageSource as JaxSource
from repro.launch.train import main as jax_main
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import train as jax_train
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import schedule, topology
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.launch.train import main, parse_hp_overrides
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.train.loop import TrainConfig, train
from repro_torch.utils.convert import state_from_jax


_JAX_INITS = {name: jax_alg.get_algorithm(name).init_state
              for name in ("fedprox", "splitfed", "parallelsfl")}


def _reference_init(arch, name, seed, M, hp):
    model = jax_build_model(jax_get_config(arch, smoke=True))
    init = _JAX_INITS[name]
    return jax.jit(lambda rng: init(model, rng, M, hp))(jax.random.PRNGKey(seed))


def _same_history(hist, hist_j, sim=True):
    assert len(hist) == len(hist_j) >= 2
    for a, b in zip(hist, hist_j):
        for k in ("step", "round", "participants") + (("sim_time",) if sim else ()):
            assert a[k] == b[k], (k, a, b)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, atol=1e-5)


def test_port_launcher_matches_reference_fedprox_on_a_star(monkeypatch):
    argv = ["--smoke", "--arch", "paper-mlp", "--algorithm", "fedprox",
            "--local-steps", "2", "--topology", "star", "--uplink-mbps", "10",
            "--steps", "8", "--batch-per-client", "4", "--participation-rate", "0.75",
            "--straggler-frac", "0.5", "--prox-mu", "0.05"]
    cfg = get_config("paper-mlp", smoke=True)
    ref = jax_alg.get_algorithm("fedprox")
    states = {}

    def jax_init(model, rng, num_clients, hp):
        states["j"] = _reference_init("paper-mlp", "fedprox", 0, num_clients, hp)
        return states["j"]

    def port_init(model, gen, num_clients, hp):
        return state_from_jax("fedprox", jax.tree.map(np.asarray, states["j"]),
                              "cpu", cfg)

    monkeypatch.setitem(jax_alg._REGISTRY, "fedprox",
                        dataclasses.replace(ref, init_state=jax_init))
    monkeypatch.setitem(alg_mod._REGISTRY, "fedprox", dataclasses.replace(
        alg_mod.get_algorithm("fedprox"), init_state=port_init))
    _, hist_j = jax_main(argv + ["--prefetch", "0"])
    _, hist = main(argv + ["--device", "cpu"])
    _same_history(hist, hist_j)
    assert hist[-1]["sim_time"] > 0


@pytest.mark.parametrize("name,kind,skw", [
    ("splitfed", "multi_server", {"participation_rate": 0.75, "straggler_frac": 0.5,
                                  "seed": 2}),
    ("parallelsfl", "clustered", {"capability_batching": True, "straggler_frac": 0.5,
                                  "seed": 1}),
])
def test_loop_bills_topology_as_reference(name, kind, skw):
    arch, M, b = "paper-mlp", 8, 4
    cfg = get_config(arch, smoke=True)
    kw = dict(num_classes=10, num_tasks=M, image_size=cfg.image_size,
              channels=cfg.image_channels)
    scfg, scfg_j = schedule.ScheduleConfig(**skw), jax_schedule.ScheduleConfig(**skw)
    width = schedule.padded_batch_per_client(scfg, b) * 2
    topo = topology.build_topology(kind, M, num_servers=2,
                                   uplink=topology.mbps(20.0, 1e-3),
                                   backbone=topology.mbps(100.0, 1e-3))
    topo_j = jax_topo.build_topology(kind, M, num_servers=2,
                                     uplink=jax_topo.mbps(20.0, 1e-3),
                                     backbone=jax_topo.mbps(100.0, 1e-3))
    common = dict(steps=6, algorithm=name, lr=0.1, local_steps=2, log_every=1,
                  batch_per_client=b)
    cap = tuple(jax_schedule.capability_profile(M, scfg_j))
    state_j = _reference_init(arch, name, 3, M, jax_alg.HParams(
        lr=0.1, local_steps=2, capability=cap))
    _, hist_j = jax_train(
        jax_build_model(jax_get_config(arch, smoke=True)), jax_sgd(0.1),
        jax_client_batches(JaxSource(**kw), width, steps=3, as_numpy=True),
        JaxTrainConfig(**common, prefetch=0, schedule=scfg_j, topology=topo_j),
        M, log=lambda _: None, init_state=state_j)
    _, hist = train(
        build_model(cfg), sgd(0.1), client_batches(MultiTaskImageSource(**kw), width),
        TrainConfig(**common, device="cpu", schedule=scfg, topology=topo),
        M, log=lambda _: None,
        init_state=state_from_jax(name, jax.tree.map(np.asarray, state_j), "cpu", cfg))
    _same_history(hist, hist_j)


def test_hp_flags_and_refusals():
    assert parse_hp_overrides(["sample_weighted=true", "prox-mu=0.5",
                               "num_clusters=3"]) == {
        "sample_weighted": True, "prox_mu": 0.5, "num_clusters": 3}
    with pytest.raises(SystemExit):
        parse_hp_overrides(["sample_weighted=maybe"])
    # the refusals that stay: a malformed --mesh spec, a chunk that does
    # not divide M (smoke M = 3), and --async with --client-chunk, as the
    # reference's (tests/test_torch_mesh_launch.py runs a real --mesh)
    for flags in (["--mesh", "2"], ["--client-chunk", "2"],
                  ["--async", "--client-chunk", "1"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--smoke", *flags])
    cfg = get_config("paper-mlp", smoke=True)
    with pytest.raises(TypeError, match="not a mesh"):
        train(build_model(cfg), sgd(0.1), iter(()),
              TrainConfig(device="cpu", mesh=1), 3)
    with pytest.raises(ValueError, match="async_mode is incompatible"):
        train(build_model(cfg), sgd(0.1), iter(()),
              TrainConfig(device="cpu", async_mode=True, client_chunk=1), 3)
