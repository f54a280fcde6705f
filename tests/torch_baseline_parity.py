"""Shared by the tests of the port's six federated baselines
(`tests/test_torch_baselines_*.py`): run one algorithm's round in both
packages from one initial state and hold them together.

The reference state is drawn by the reference's `init_state` (jitted) and
carried across with `state_from_jax`; both packages see the same numpy
round batches; each draws its own schedule (byte-identical streams, see
tests/test_torch_data_schedule.py). The reference round is the dense
`jit_round_fn` (a live run, never the stored goldens). Per round the
losses and per-task losses agree within TOL, and after the last round every
state leaf (with FedEM's pi, SMoFi's smom and ParallelSFL's cidx, which
must be equal) and the final eval agree too. Where the reference has no
eval for the family (fedavg, fedprox and parallelsfl read class labels,
FedEM's asserts a classifier), the port's must refuse the batch as well.

The VLM's and the encoder-decoder's batches carry `vis` / `frames` as
tests/test_torch_zoo_round.py's `zoo_batches` draws them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import schedule
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import state_from_jax
from repro_torch.utils.tree import tree_leaves_with_path

BASELINES = ["fedavg", "fedprox", "splitfed", "smofi", "parallelsfl", "fedem"]
ROUNDS, LOCAL_STEPS, LR, TOL = 3, 2, 0.1, 1e-5
SEQ_LEN = 24
# name: a fixed (mask, budget) pair, or ScheduleConfig kwargs of a drawn
# stream. "masked" is the reference's own cell (tests/test_sharding_parity.py):
# every other client sits out and has budget 1. "straggler" draws
# participants with budget-1 stragglers among them; "capability" gives
# every participant the full budget and a per-step batch by its speed,
# with the FedAvg-family means weighted by those sizes.
SCHEDULES = {
    "full": None,
    "masked": "fixed",
    "straggler": {"participation_rate": 0.75, "straggler_frac": 0.5, "seed": 2},
    "capability": {"capability_batching": True, "straggler_frac": 0.5, "seed": 1,
                   "sample_weighted": True},
}


@pytest.fixture(scope="module")
def one_thread():
    """torch on one intra-op thread for a module's cases: the smoke LMs'
    rounds are small, and under the suite's parallel workers more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scfg(sched):
    kw = SCHEDULES[sched]
    return schedule.ScheduleConfig(**(kw if isinstance(kw, dict) else {}))


def _hparams(module, sched, M, lr=LR):
    scfg = _scfg(sched)
    cap = None if scfg.is_trivial else tuple(schedule.capability_profile(M, scfg))
    return module.HParams(lr=lr, local_steps=LOCAL_STEPS,
                          sample_weighted=scfg.sample_weighted, capability=cap)


@functools.lru_cache(maxsize=None)
def _reference(arch, name, M, hp):
    """(cfg, model, initial state, jitted round, jitted eval) of the
    reference, shared by a test file's cases; the eval is the exception
    the reference raises where it has none for the family."""
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    alg = jax_alg.get_algorithm(name)
    init = jax.jit(lambda rng: alg.init_state(model, rng, M, hp))(jax.random.PRNGKey(7))
    try:
        ev = jax.jit(alg.eval_fn(model, M))
    except AssertionError as e:  # FedEM's eval asserts a classifier
        ev = e
    return cfg, model, init, jax_alg.jit_round_fn(alg, model, M, hp), ev


def _streams(sched, M, width):
    """The two packages' schedule iterators."""
    kw = SCHEDULES[sched]
    if kw is None:
        return (iter(lambda: jax_schedule.full_schedule(M, LOCAL_STEPS), None),
                iter(lambda: schedule.full_schedule(M, LOCAL_STEPS), None))
    if kw == "fixed":
        mask = np.array([1.0, 0.0] * (M // 2), np.float32)
        budget = np.array([LOCAL_STEPS, 1] * (M // 2), np.int32)
        ref = jax_schedule.ClientSchedule(mask=jnp.asarray(mask),
                                          budget=jnp.asarray(budget))
        return (iter(lambda: ref, None),
                iter(lambda: schedule.ClientSchedule(mask=mask, budget=budget), None))
    return (jax_schedule.schedule_stream(jax_schedule.ScheduleConfig(**kw), M,
                                         LOCAL_STEPS, width),
            schedule.schedule_stream(schedule.ScheduleConfig(**kw), M,
                                     LOCAL_STEPS, width))


def batches(cfg, M, width, n, seed=0):
    """n round batches of `width` samples a step, LOCAL_STEPS steps: the
    classifiers' images, or tokens from the LM source with the VLM's "vis"
    [M, w, vis_seq, vis_dim] or the encoder-decoder's "frames" [M, w,
    encoder_seq, d_model] in f32 from np.random.default_rng(seed)."""
    w = width * LOCAL_STEPS
    if cfg.family in ("mlp", "resnet"):
        src = MultiTaskImageSource(num_classes=cfg.num_classes, num_tasks=M,
                                   image_size=cfg.image_size,
                                   channels=cfg.image_channels, seed=seed)
        return list(client_batches(src, w, steps=n, seed=seed))
    src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=M, beta=0.5,
                            seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for batch in client_batches(src, w, steps=n, seed=seed, seq_len=SEQ_LEN):
        if cfg.family == "vlm":
            batch["vis"] = rng.standard_normal((M, w, cfg.vis_seq, cfg.vis_dim),
                                               dtype=np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (M, w, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        out.append(batch)
    return out


def _leaves_ref(state):
    if isinstance(state, tuple):  # fedem: (components, pi)
        return {**{f"components/{k}": v for k, v in flatten_dict(state[0]).items()},
                "pi": state[1]}
    return flatten_dict(state)


def _leaves_port(state):
    if isinstance(state, tuple):
        return {**{f"components/{k}": v for k, v in tree_leaves_with_path(state[0])},
                "pi": state[1]}
    return dict(tree_leaves_with_path(state))


def run_parity(arch, name, sched, M, width, lr=LR, hold_params=True):
    """ROUNDS rounds of `name` under schedule `sched` in both packages;
    asserts the agreement described in the module docstring (with
    hold_params=False, the losses only)."""
    hp_j = _hparams(jax_alg, sched, M, lr)
    cfg_j, model_j, state_j, rf_j, ev_j = _reference(arch, name, M, hp_j)
    cfg = get_config(arch, smoke=True)
    assert cfg.__dict__ == cfg_j.__dict__
    model = build_model(cfg)
    alg = alg_mod.get_algorithm(name)
    rf = alg.round_fn(model, M, _hparams(alg_mod, sched, M, lr))
    state = state_from_jax(name, jax.tree.map(np.asarray, state_j), "cpu", cfg)
    padded = schedule.padded_batch_per_client(_scfg(sched), width)
    stream_j, stream = _streams(sched, M, width)
    for batch in batches(cfg, M, padded, ROUNDS):
        state_j, met_j = rf_j(state_j, batch, next(stream_j))
        state, met = rf(state, stage_batch(batch, "cpu"), next(stream))
        assert set(met) == set(met_j)
        np.testing.assert_allclose(float(met["loss"]), float(met_j["loss"]),
                                   rtol=TOL, atol=TOL)
        if "per_task" in met:
            np.testing.assert_allclose(met["per_task"].numpy(),
                                       np.asarray(met_j["per_task"]),
                                       rtol=TOL, atol=TOL)
    if not hold_params:
        return
    want, got = _leaves_ref(state_j), _leaves_port(state)
    assert sorted(want) == sorted(got)
    for path, a in got.items():
        a, b = a.detach().numpy(), np.asarray(want[path])
        if path.endswith("cidx"):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=path)
    ev_batch = batches(cfg, M, 4, 1, seed=9)[0]
    if cfg.family not in ("mlp", "resnet"):
        ev_batch = {k: v[:, :4] for k, v in ev_batch.items()}
    if isinstance(ev_j, Exception):
        with pytest.raises(NotImplementedError, match="classifiers"):
            alg.eval_fn(model, M)
        return
    try:
        want_ev = ev_j(state_j, ev_batch)
    except KeyError as e:  # an eval that reads class labels
        with pytest.raises(KeyError, match=str(e)):
            alg.eval_fn(model, M)(state, stage_batch(ev_batch, "cpu"))
        return
    got_ev = alg.eval_fn(model, M)(state, stage_batch(ev_batch, "cpu"))
    if "acc_mtl" in want_ev:
        assert float(got_ev["acc_mtl"]) == float(want_ev["acc_mtl"])
        np.testing.assert_array_equal(got_ev["per_task_acc"].numpy(),
                                      np.asarray(want_ev["per_task_acc"]))
    else:
        np.testing.assert_allclose(got_ev["per_task_loss"].numpy(),
                                   np.asarray(want_ev["per_task_loss"]),
                                   rtol=TOL, atol=TOL)
