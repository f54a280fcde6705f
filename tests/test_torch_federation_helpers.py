"""The port's schedule reductions, federation helpers, split helpers and
tree helpers against the JAX reference's on seeded inputs, and the round
properties the reference pins for its baselines (tests/test_schedule.py,
tests/test_async_events.py) on the port's own rounds.

Tolerances: the masked means within 1e-6 (f32 sums in another order);
everything integer or exact in f32 (masks, activity, cluster maps,
staleness weights of powers of two, sample masks) equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federation as jax_fed
from repro.core import schedule as jax_schedule
from repro.core import split as jax_split
from repro.core import topology as jax_topo
from repro.utils import tree as jax_tree
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import federation, schedule, split, topology
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils import tree
from repro_torch.utils.device import generator

M = 8
BASELINES = ["fedavg", "fedprox", "splitfed", "smofi", "parallelsfl", "fedem"]


def _masks(rng):
    return [np.ones(M, np.float32), np.zeros(M, np.float32),
            (rng.random(M) < 0.5).astype(np.float32),
            np.eye(M, dtype=np.float32)[3]]


@pytest.mark.parametrize("weighted", ["none", "sizes", "uniform", "zero-sizes"])
def test_participation_means_match_reference(weighted):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, 5, 3)).astype(np.float32)
    weights = {"none": None,
               "sizes": rng.integers(0, 9, size=M).astype(np.float32),
               "uniform": np.full(M, 4.0, np.float32),
               "zero-sizes": np.zeros(M, np.float32)}[weighted]
    for mask in _masks(rng):
        wj = None if weights is None else jnp.asarray(weights)
        wt = None if weights is None else torch.tensor(weights)
        want = np.asarray(jax_schedule.participation_mean(jnp.asarray(x), jnp.asarray(mask), wj))
        got = schedule.participation_mean(torch.tensor(x), torch.tensor(mask), wt)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        want_b = np.asarray(jax_schedule.participation_bcast_mean(
            jnp.asarray(x), jnp.asarray(mask), wj))
        got_b = schedule.participation_bcast_mean(torch.tensor(x), torch.tensor(mask), wt)
        assert got_b.is_contiguous() and got_b.shape == x.shape
        np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-6, atol=1e-6)
        if weighted == "uniform":  # uniform weights: the unweighted mean, bit for bit
            assert torch.equal(got, schedule.participation_mean(
                torch.tensor(x), torch.tensor(mask)))


def test_participation_mean_is_not_torch_mean():
    """The reference's formula sum(x·w) / max(sum w, 1), not torch.mean: an
    all-ones mask matches the reference within f32 rounding (the two
    formulas differ by 5.96e-8 there, ROADMAP queue 3)."""
    x = np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32)
    ones = np.ones(3, np.float32)
    want = np.asarray(jax_schedule.participation_mean(jnp.asarray(x), jnp.asarray(ones)))
    got = schedule.participation_mean(torch.tensor(x), torch.tensor(ones)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, (x * ones[:, None]).sum(0) / np.float32(3.0))


def test_activity_staleness_and_sample_masks_match_reference():
    rng = np.random.default_rng(1)
    for _ in range(4):
        mask = (rng.random(M) < 0.6).astype(np.float32)
        budget = rng.integers(1, 4, size=M).astype(np.int32)
        want = np.asarray(jax_schedule.step_activity(jnp.asarray(mask),
                                                     jnp.asarray(budget), 3))
        got = schedule.step_activity(torch.tensor(mask), torch.tensor(budget), 3)
        np.testing.assert_array_equal(got.numpy(), want)
    stale = np.array([0, 1, 2, 3, 5, 8, 0, 4], np.int32)
    for decay, cut in ((1.0, None), (0.5, None), (0.5, 3), (0.25, 0)):
        want = np.asarray(jax_schedule.staleness_weights(jnp.asarray(stale), decay, cut))
        got = schedule.staleness_weights(torch.tensor(stale), decay, cut)
        np.testing.assert_array_equal(got.numpy(), want)
    w, x = torch.arange(4.0), torch.zeros(4, 2, 3)
    assert schedule.broadcast_weights(w, x).shape == (4, 1, 1)
    sizes = np.array([0, 3, 8, 1, 5, 2, 8, 0], np.int32)
    sched_j = jax_schedule.ClientSchedule(mask=jnp.asarray((sizes > 0).astype(np.float32)),
                                          budget=jnp.full(M, 2, jnp.int32),
                                          sizes=jnp.asarray(sizes))
    sched = schedule.ClientSchedule(mask=(sizes > 0).astype(np.float32),
                                    budget=np.full(M, 2, np.int32), sizes=sizes)
    batch = {"image": np.zeros((M, 2, 8, 4), np.float32)}
    np.testing.assert_array_equal(
        schedule.schedule_sample_mask(sched, stage_batch(batch, "cpu")).numpy(),
        np.asarray(jax_schedule.schedule_sample_mask(sched_j, batch)))
    assert schedule.schedule_sample_mask(sched._replace(sizes=None), batch) is None


def test_capability_profile_from_a_topology_matches_reference():
    cap = (1.0, 0.5, 0.25, 1.0, 0.75, 1.0, 0.3, 0.9)
    scfg = schedule.ScheduleConfig(straggler_frac=0.5, seed=4)
    scfg_j = jax_schedule.ScheduleConfig(straggler_frac=0.5, seed=4)
    for topo, topo_j in ((None, None), (topology.star(M, capability=cap),
                                        jax_topo.star(M, capability=cap))):
        np.testing.assert_array_equal(schedule.capability_profile(M, scfg, topo),
                                      jax_schedule.capability_profile(M, scfg_j, topo_j))


@pytest.mark.parametrize("algorithm", ["mtsl", "splitfed", "fedavg"])
def test_sync_transform_matches_reference(algorithm):
    rng = np.random.default_rng(2)
    g = {"towers": {"w": rng.normal(size=(M, 4, 3)).astype(np.float32)},
         "server": {"w": rng.normal(size=(3, 2)).astype(np.float32)}}
    want = jax_fed.sync_transform(algorithm, M)(jax.tree.map(jnp.asarray, g))
    got = federation.sync_transform(algorithm, M)(tree.tree_map(torch.tensor, g))
    for k in ("towers", "server"):
        np.testing.assert_allclose(got[k]["w"].numpy(), np.asarray(want[k]["w"]),
                                   rtol=1e-6, atol=1e-6)


def test_cluster_assignment_and_means_match_reference():
    rng = np.random.default_rng(3)
    for Mc, C, cap in ((8, 2, None), (7, 3, None), (8, 3, rng.uniform(0.2, 1, 8)),
                       (5, 9, None), (6, 2, np.ones(6)), (10, 4, rng.uniform(0.2, 1, 10))):
        cidx, n = federation.cluster_assignment(Mc, C, cap)
        cidx_j, n_j = jax_fed.cluster_assignment(Mc, C, cap)
        assert n == n_j
        np.testing.assert_array_equal(cidx, cidx_j)
        x = rng.normal(size=(Mc, 4, 2)).astype(np.float32)
        w = (rng.random(Mc) < 0.7).astype(np.float32)
        (got,), wc = federation._cluster_wmean(
            [torch.tensor(x)], torch.tensor(w),
            federation._cluster_onehot(torch.as_tensor(cidx), n))
        want, wc_j = jax_fed._cluster_wmean(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(cidx), n_j)
        np.testing.assert_array_equal(wc.numpy(), np.asarray(wc_j))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_split_and_tree_helpers_match_reference():
    freeze, freeze_j = split.client_freeze_lr(M, 3), jax_split.client_freeze_lr(M, 3)
    np.testing.assert_array_equal(freeze.clients.numpy(), np.asarray(freeze_j.clients))
    assert float(freeze.server) == float(freeze_j.server) == 0.0
    model = build_model(get_config("paper-mlp", smoke=True))
    towers = split.replicate_tower(model.init_tower, generator("cpu", 0), M)
    for x in tree.tree_leaves(towers):
        assert x.shape[0] == M and x.is_contiguous()
        assert all(torch.equal(x[0], x[m]) for m in range(M))
    nested = {"a": {"b": np.ones((2, 3), np.float32), "c": np.zeros(4, np.int32)},
              "d": np.ones((), np.float64)}
    assert tree.flatten_dict(nested).keys() == jax_tree.flatten_dict(nested).keys()
    assert tree.unflatten_dict(tree.flatten_dict(nested)).keys() == nested.keys()
    assert tree.tree_size(nested) == jax_tree.tree_size(nested) == 11
    t = tree.tree_map(torch.tensor, nested)
    assert tree.tree_bytes(t) == jax_tree.tree_bytes(nested) == 48
    pred = lambda path, _: path.startswith("a")  # noqa: E731
    yes, no = tree.partition(nested, pred)
    yes_j, no_j = jax_tree.partition(nested, pred)
    assert (yes["d"] is None) and (yes_j["d"] is None) and (no["a"]["b"] is None)
    merged = tree.merge(yes, no)
    assert all(merged["a"][k] is nested["a"][k] for k in ("b", "c"))


def _mlp_setup(name, local_steps=2):
    cfg = get_config("paper-mlp", smoke=True)
    model = build_model(cfg)
    alg = alg_mod.get_algorithm(name)
    hp = alg_mod.HParams(lr=0.1, local_steps=local_steps)
    state = alg.init_state(model, generator("cpu", 1), M, hp)
    rng = np.random.default_rng(4)
    batch = {"image": rng.normal(size=(M, 4 * local_steps, 8, 8)).astype(np.float32),
             "label": rng.integers(0, 10, size=(M, 4 * local_steps)).astype(np.int32)}
    return model, alg, hp, state, stage_batch(batch, "cpu")


def _copy_state(state):
    if isinstance(state, tuple):
        return (tree.tree_map(torch.clone, state[0]), state[1].clone())
    return tree.tree_map(torch.clone, state)


def _leaves(state):
    if isinstance(state, tuple):
        return tree.tree_leaves(state[0]) + [state[1]]
    return tree.tree_leaves(state)


@pytest.mark.parametrize("name", BASELINES)
def test_round_properties(name):
    """An all-ones schedule is bit-identical to none; the round is the
    composition of its phases; the phases leave the state they are given
    unchanged; a held straggler row's parameters do not move in the local
    phase (fedavg family and fedem) and a non-participant's tower does not
    move (split family)."""
    model, alg, hp, state, batch = _mlp_setup(name)
    rf = alg.round_fn(model, M, hp)
    before = _copy_state(state)
    a, met_a = rf(_copy_state(state), batch, None)
    b, met_b = rf(_copy_state(state), batch, schedule.full_schedule(M, 2))
    assert torch.equal(met_a["loss"], met_b["loss"])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    sched = schedule.ClientSchedule(mask=np.array([1, 0] * 4, np.float32),
                                    budget=np.array([1, 2] * 4, np.int32))
    prog = alg.phases(model, M, hp)
    payload = prog.local(state, batch, sched)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(state), _leaves(before)))
    c, met_c = prog.apply(state, payload, sched)
    d, met_d = rf(_copy_state(state), batch, sched)
    assert torch.equal(met_c["loss"], met_d["loss"])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(c), _leaves(d)))
    if name in ("fedavg", "fedprox", "fedem"):
        # client 0: budget 1 of 2; its row after the round's local phase
        # equals its row after one step
        one = alg_mod.get_algorithm(name).phases(
            model, M, alg_mod.HParams(lr=0.1, local_steps=1))
        first = {k: v[:, :4] for k, v in batch.items()}
        p1 = one.local(state, first, schedule.full_schedule(M, 1))
        key = "pcs" if name != "fedem" else "comps"
        for x, y in zip(tree.tree_leaves(payload[key]), tree.tree_leaves(p1[key])):
            assert torch.equal(x[0], y[0])
    if name in ("splitfed", "smofi", "parallelsfl"):
        towers = payload["params"]["towers"] if name == "splitfed" else payload["towers"]
        for x, y in zip(tree.tree_leaves(towers), tree.tree_leaves(state["towers"])):
            assert torch.equal(x[1], y[1])


def test_fedem_train_step_matches_reference():
    """The single-step EM form of FedEM (`build_fedem_train_step`), 3 steps
    with sgd(0.05) on smoke paper-mlp, K = 2, as the reference's own
    tests/test_mtsl_core.py drives it: loss, pi and every component leaf
    within 1e-5 (pi's rows sum to 1), then the mixture eval's accuracies
    equal."""
    from repro.configs import get_config as jax_get_config
    from repro.models.registry import build_model as jax_build_model
    from repro.optim import sgd as jax_sgd
    from repro.utils.sharding import strip
    from repro.utils.tree import flatten_dict
    from repro_torch.optim import sgd
    from repro_torch.utils.convert import state_from_jax

    cfg = get_config("paper-mlp", smoke=True)
    M, K = cfg.num_clients, 2
    model_j = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    comps_j, pi_j = jax_fed.init_fedem_state(model_j, jax.random.PRNGKey(0), M, K)
    comps_j = strip(comps_j)
    opt_j = jax_sgd(0.05)
    state_j = jax_fed.FedEMState(comps_j, pi_j, opt_j.init(comps_j),
                                 jnp.zeros((), jnp.int32))
    comps, pi = state_from_jax("fedem", jax.tree.map(np.asarray, (comps_j, pi_j)),
                               "cpu", cfg)
    model = build_model(cfg)
    state = federation.FedEMState(comps, pi, (), 0)
    step_j = jax.jit(jax_fed.build_fedem_train_step(model_j, opt_j, M, K))
    step = federation.build_fedem_train_step(model, sgd(0.05), M, K)
    rng = np.random.default_rng(5)
    for _ in range(3):
        lab = rng.integers(0, cfg.num_classes, size=(M, 4)).astype(np.int32)
        img = (rng.normal(size=(M, 4, 8, 8)) + lab[..., None, None] * 0.4).astype(np.float32)
        batch = {"image": img, "label": lab}
        state_j, met_j = step_j(state_j, batch)
        state, met = step(state, stage_batch(batch, "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(met_j["loss"]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.pi.numpy(), np.asarray(state_j.pi), atol=1e-5)
    np.testing.assert_allclose(state.pi.sum(-1).numpy(), 1.0, atol=1e-5)
    want = flatten_dict(state_j.components)
    for path, leaf in tree.tree_leaves_with_path(state.components):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[path]),
                                   rtol=1e-5, atol=1e-5, err_msg=path)
    ev_j = jax_fed.build_fedem_eval_step(model_j, M)(state_j, batch)
    ev = federation.build_fedem_eval_step(model, M)(state, stage_batch(batch, "cpu"))
    np.testing.assert_array_equal(ev["per_task_acc"].numpy(),
                                  np.asarray(ev_j["per_task_acc"]))
