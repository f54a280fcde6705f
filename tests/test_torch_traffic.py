"""The port's traffic billing against the JAX reference's: the registry's
`round_events` and `round_bytes` of all seven algorithms, on star(M) and on
every kind of `build_topology` (with a capability profile and capability
sizes, partial participation, and the multi-server sync round on and off);
`comm_cost.round_cost`; `simulate_round_walltime`; and
`model_param_counts`, which the port counts from its own inits on the meta
device (nothing allocated) and the reference through `jax.eval_shape` for
the full LM configs. Everything must be equal: these are integer byte
counts and float64 host arithmetic on the same values."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import comm_cost as jax_cc
from repro.core import topology as jax_topo
from repro.core.schedule import ClientSchedule as JaxClientSchedule
from repro.models.registry import build_model as jax_build_model
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import comm_cost, topology
from repro_torch.core.schedule import ClientSchedule
from repro_torch.models.registry import build_model

M, B = 8, 16
ALGS = ["mtsl", "splitfed", "fedavg", "fedprox", "fedem", "smofi", "parallelsfl"]
CAP = (1.0, 0.5, 0.25, 1.0, 0.75, 1.0, 0.3, 0.9)
SIZES = np.array([16, 8, 0, 16, 12, 0, 5, 15], np.int32)
MASK = (SIZES > 0).astype(np.float32)
BUDGET = np.array([2, 1, 1, 2, 1, 2, 1, 2], np.int32)


def _topologies(mod, kind):
    lat = 2e-3
    return mod.build_topology(kind, M, num_servers=2,
                              uplink=mod.mbps(10.0, lat), downlink=mod.mbps(40.0, lat),
                              backbone=mod.mbps(1000.0, lat), capability=CAP,
                              sync_every=2)


def _events(evs):
    return [(e.src, e.dst, e.bytes, e.phase, e.direction) for e in evs]


def test_registry_lists_the_reference_algorithms():
    assert alg_mod.list_algorithms() == jax_alg.list_algorithms()
    for name in ALGS:
        a, b = alg_mod.get_algorithm(name), jax_alg.get_algorithm(name)
        for field in ("uses_optimizer", "donate_state", "replica_avg_all",
                      "description"):
            assert getattr(a, field) == getattr(b, field), (name, field)
        assert (a.phases is None) == (b.phases is None)
        assert (a.serve_params is None) == (b.serve_params is None)
        hp, hp_j = alg_mod.HParams(local_steps=3), jax_alg.HParams(local_steps=3)
        assert a.steps_per_round(hp) == b.steps_per_round(hp_j)


@pytest.mark.parametrize("arch", ["paper-mlp", "paper-resnet16", "mamba2-130m"])
@pytest.mark.parametrize("kind", ["star", "clustered", "hierarchical", "multi_server"])
def test_round_events_and_bytes_match_reference(kind, arch):
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    topo, topo_j = _topologies(topology, kind), _topologies(jax_topo, kind)
    for field in ("name", "clients", "servers", "attach", "capability", "core",
                  "sync_every"):
        assert getattr(topo, field) == getattr(topo_j, field), field
    assert ({k: (v.bandwidth_bytes_per_s, v.latency_s) for k, v in topo.links.items()}
            == {k: (v.bandwidth_bytes_per_s, v.latency_s)
                for k, v in topo_j.links.items()})
    tower, total = 1_000, 5_000
    for name in ALGS:
        hp = alg_mod.HParams(local_steps=3, num_clusters=2, num_components=4)
        hp_j = jax_alg.HParams(local_steps=3, num_clusters=2, num_components=4)
        alg, alg_j = alg_mod.get_algorithm(name), jax_alg.get_algorithm(name)
        for kw in ({}, {"num_participants": 5}, {"sizes": SIZES},
                   {"sizes": SIZES, "sync_round": False}):
            got = alg.round_events(topo, cfg, M, B, hp, tower_params=tower,
                                   total_params=total, **kw)
            want = alg_j.round_events(topo_j, cfg_j, M, B, hp_j, tower_params=tower,
                                      total_params=total, **kw)
            assert _events(got) == _events(want), (name, kw)
            assert (comm_cost.round_cost_from_events(topo, got)
                    .__dict__ == jax_cc.round_cost_from_events(topo_j, want).__dict__)
        for kw in ({}, {"num_participants": 3}, {"samples_per_step": 37}):
            assert (alg.round_bytes(cfg, M, B, hp, tower_params=tower,
                                    total_params=total, **kw)
                    == alg_j.round_bytes(cfg_j, M, B, hp_j, tower_params=tower,
                                         total_params=total, **kw)), (name, kw)


@pytest.mark.parametrize("kind", ["star", "clustered", "hierarchical", "multi_server"])
def test_simulated_walltime_matches_reference(kind):
    cfg, cfg_j = get_config("paper-mlp"), jax_get_config("paper-mlp")
    topo, topo_j = _topologies(topology, kind), _topologies(jax_topo, kind)
    sched = ClientSchedule(mask=MASK, budget=BUDGET, sizes=SIZES)
    sched_j = JaxClientSchedule(mask=jax.numpy.asarray(MASK),
                                budget=jax.numpy.asarray(BUDGET),
                                sizes=jax.numpy.asarray(SIZES))
    for name in ALGS:
        alg, alg_j = alg_mod.get_algorithm(name), jax_alg.get_algorithm(name)
        for r in (1, 2):
            kw = dict(tower_params=1_000, total_params=5_000, time_per_sample_s=1e-3,
                      round_idx=r, local_steps=2)
            got = alg_mod.simulate_round_walltime(
                alg, topo, cfg, M, B, alg_mod.HParams(local_steps=2), sched, **kw)
            want = jax_alg.simulate_round_walltime(
                alg_j, topo_j, cfg_j, M, B, jax_alg.HParams(local_steps=2), sched_j, **kw)
            assert got == want, (name, r)


def test_round_cost_matches_reference():
    for arch in ("paper-mlp", "paper-resnet16", "zamba2-7b"):
        cfg, cfg_j = get_config(arch), jax_get_config(arch)
        for name in ALGS:
            kw = dict(seq_len=7, tower_params=1_000, total_params=5_000,
                      local_steps=3, num_participants=5, samples_per_step=40)
            assert (comm_cost.round_cost(name, cfg, M, B, **kw).__dict__
                    == jax_cc.round_cost(name, cfg_j, M, B, **kw).__dict__)


def _reference_counts(arch):
    model = jax_build_model(jax_get_config(arch))
    key = jax.random.PRNGKey(0)

    def n(fn):
        return sum(int(np.prod(x.shape)) for x in
                   jax.tree.leaves(jax.eval_shape(lambda k: strip(fn(k)), key)))

    tower = n(model.init_tower)
    return tower, tower + n(model.init_server)


@pytest.mark.parametrize("arch", ["paper-mlp", "paper-resnet16", "mamba2-130m",
                                  "zamba2-7b"])
def test_model_param_counts_match_reference(arch):
    got = comm_cost.model_param_counts(build_model(get_config(arch)))
    assert got == _reference_counts(arch)
    if arch in ("paper-mlp", "paper-resnet16"):  # small: the reference's own call
        assert got == jax_cc.model_param_counts(jax_build_model(jax_get_config(arch)))
    if arch == "zamba2-7b":
        # two towers and the server: the 7.26 B parameters of the M = 2
        # full-width mtsl run on the card
        tower, total = got
        assert total + tower == 7_255_081_696


def _marks_ref(marks):
    flat, _ = jax.tree_util.tree_flatten_with_path(marks)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                     for k in path): bool(v) for path, v in flat}


def _marks_port(marks):
    from repro_torch.utils.tree import tree_leaves_with_path

    if isinstance(marks, tuple) and not hasattr(marks, "_fields"):
        return {**{f"0/{k}": v for k, v in tree_leaves_with_path(marks[0])},
                **{"1": marks[1]}}
    if hasattr(marks, "_fields"):  # TrainState(params, opt_state, step)
        return {**{f"params/{k}": v for k, v in tree_leaves_with_path(marks.params)},
                "step": marks.step}
    return dict(tree_leaves_with_path(marks))


@pytest.mark.parametrize("name", ALGS)
def test_client_axes_match_reference(name):
    """Each registration declares the reference's client-axis marks."""
    from repro_torch.utils.device import generator

    cfg_j = jax_get_config("paper-mlp", smoke=True)
    hp_j, hp = jax_alg.HParams(local_steps=2), alg_mod.HParams(local_steps=2)
    alg_j, alg = jax_alg.get_algorithm(name), alg_mod.get_algorithm(name)
    state_j = alg_j.init_state(jax_build_model(cfg_j), jax.random.PRNGKey(0), 4, hp_j)
    state = alg.init_state(build_model(get_config("paper-mlp", smoke=True)),
                           generator("cpu", 0), 4, hp)
    assert _marks_port(alg.client_axes(state)) == _marks_ref(alg_j.client_axes(state_j))
