"""The port's async round pipeline (`repro_torch.train.pipeline`) and the
loop that runs it, against `repro.train.pipeline` / `repro.train.loop`.

  * BackgroundIterator: order, an exception at its position, close() of a
    blocked producer; `pipeline_rounds` equals zip at depths 0, 1 and 3;
    MetricsRing reads back in push order (the reference's cases of
    tests/test_pipeline.py).
  * Any prefetch depth gives the synchronous trajectory, bit for bit
    within the port, for all seven algorithms (history and final state),
    and a checkpointed run resumed at prefetch 2 equals an uninterrupted
    one.
  * The port's loop at prefetch 2 against a live reference run at
    prefetch 2 (paper-mlp smoke, f32, 3 rounds, lr 0.05, the reference's
    draw carried across): losses within 1e-5 of their scale. The stored
    goldens of tests/test_pipeline.py are not used: they fail on this
    JAX.
"""
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.data.pipeline import client_batches as jax_client_batches
from repro.data.synthetic import MultiTaskImageSource as JaxSource
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import train as jax_train
from repro_torch.configs import get_config
from repro_torch.core.algorithms import list_algorithms
from repro_torch.core.schedule import ScheduleConfig
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.train.checkpoint import load_algorithm_state
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.pipeline import BackgroundIterator, MetricsRing, pipeline_rounds
from repro_torch.utils.convert import state_from_jax

CFG = get_config("paper-mlp", smoke=True)
MODEL = build_model(CFG)
M = CFG.num_clients
ALL_ALGS = sorted(list_algorithms())
SCHED = {"participation_rate": 0.75, "straggler_frac": 0.5, "seed": 3}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _source():
    return MultiTaskImageSource(num_classes=M, image_size=CFG.image_size,
                                channels=CFG.image_channels, seed=0)


def _run(alg, prefetch, rounds=4, **kw):
    ls = 1 if alg == "mtsl" else 2
    tcfg = TrainConfig(steps=rounds * ls, algorithm=alg, lr=0.05, local_steps=ls,
                       log_every=1, device="cpu", prefetch=prefetch,
                       schedule=ScheduleConfig(**SCHED), **kw)
    return train(MODEL, sgd(0.05), client_batches(_source(), 4 * ls, seed=0),
                 tcfg, M, log=lambda _: None)


# ---------------------------------------------------------- the primitives


def test_background_iterator_preserves_order():
    assert list(BackgroundIterator(iter(range(50)), depth=3)) == list(range(50))


def test_background_iterator_relays_exception_at_position():
    def gen():
        yield 0
        yield 1
        raise RuntimeError("boom")

    it = BackgroundIterator(gen(), depth=2)
    assert next(it) == 0 and next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_background_iterator_close_unblocks_producer():
    it = BackgroundIterator(itertools_count(), depth=1)
    assert next(it) == 0
    time.sleep(0.05)  # the producer is now blocked on a full queue
    it.close()
    it._thread.join(timeout=2.0)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def itertools_count():
    i = 0
    while True:
        yield i
        i += 1


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_pipeline_rounds_equals_zip(depth):
    rng = np.random.default_rng(0)
    batches = [{"image": rng.normal(size=(2, 3)).astype(np.float32),
                "label": rng.integers(0, 9, size=(2, 3)).astype(np.int32)}
               for _ in range(7)]
    scheds = list(range(7))
    got = list(pipeline_rounds(iter(batches), iter(scheds), depth=depth,
                               num_rounds=5))
    assert [s for _, s in got] == scheds[:5]
    for (b, _), want in zip(got, batches):
        assert torch.equal(b["image"], torch.as_tensor(want["image"]))
        assert b["label"].dtype == torch.int64
        assert torch.equal(b["label"], torch.as_tensor(want["label"]).long())


def test_metrics_ring_defers_then_flushes_in_order():
    seen = []
    ring = MetricsRing(2, seen.append)
    for i in range(5):
        ring.push({"i": i, "loss": torch.tensor(float(i))})
        assert len(ring) == min(i + 1, 2)
    assert [e["i"] for e in seen] == [0, 1, 2]
    ring.flush()
    assert [e["i"] for e in seen] == list(range(5))
    assert all(isinstance(e["loss"], float) for e in seen)
    sync = []
    MetricsRing(0, sync.append).push({"loss": torch.tensor(1.5)})
    assert sync == [{"loss": 1.5}]


def test_background_iterator_runs_on_another_thread():
    main = threading.get_ident()
    ids = list(BackgroundIterator((threading.get_ident() for _ in range(3)), depth=2))
    assert all(i != main for i in ids)


# ------------------------------------------------ the loop at any depth


@pytest.mark.parametrize("alg", ALL_ALGS)
def test_pipelined_matches_synchronous_bit_for_bit(alg):
    s0, h0 = _run(alg, 0)
    s, h = _run(alg, 2)
    assert [e["loss"] for e in h] == [e["loss"] for e in h0]
    assert [e["participants"] for e in h] == [e["participants"] for e in h0]
    assert _bits_equal(s, s0)


@pytest.mark.parametrize("alg", ["mtsl", "fedavg"])
def test_resume_at_prefetch_two_matches_uninterrupted(alg, tmp_path):
    rounds, cut = 6, 3
    ls = 1 if alg == "mtsl" else 2
    full, hist = _run(alg, 2, rounds=rounds)
    ck = str(tmp_path / "ck.msgpack")
    _run(alg, 2, rounds=cut, checkpoint_path=ck)
    state, name, extra = load_algorithm_state(ck, cfg=CFG)
    assert name == alg and extra["round"] == cut
    tcfg = TrainConfig(steps=rounds * ls, algorithm=alg, lr=0.05, local_steps=ls,
                       log_every=1, device="cpu", prefetch=2,
                       schedule=ScheduleConfig(**SCHED))
    batches = client_batches(_source(), 4 * ls, seed=0)
    for _ in range(cut):
        next(batches)
    resumed, h2 = train(MODEL, sgd(0.05), batches, tcfg, M, log=lambda _: None,
                        init_state=state, start_round=cut)
    assert [e["loss"] for e in h2] == [e["loss"] for e in hist[cut:]]
    assert _bits_equal(resumed, full)


# ------------------------------------------- against a live reference run


@functools.lru_cache(maxsize=None)
def _reference(alg):
    ls = 1 if alg == "mtsl" else 2
    model = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    hp = jax_alg.HParams(lr=0.05, local_steps=ls)
    init = jax_alg.get_algorithm(alg).init_state
    state_j = jax.jit(lambda r: init(model, r, M, hp))(jax.random.PRNGKey(0))
    src = JaxSource(num_classes=M, image_size=CFG.image_size,
                    channels=CFG.image_channels, seed=0)
    _, hist = jax_train(
        model, jax_sgd(0.05), jax_client_batches(src, 4 * ls, steps=3, seed=0,
                                                 as_numpy=True),
        JaxTrainConfig(steps=3 * ls, algorithm=alg, lr=0.05, local_steps=ls,
                       log_every=1, prefetch=2,
                       schedule=jax_schedule.ScheduleConfig(**SCHED)),
        M, log=lambda _: None, init_state=state_j)
    return jax.tree.map(np.asarray, state_j), hist


@pytest.mark.parametrize("alg", ["mtsl", "splitfed"])
def test_port_pipeline_matches_live_reference(alg):
    torch.backends.cuda.matmul.allow_tf32 = False
    state_j, hist_j = _reference(alg)
    ls = 1 if alg == "mtsl" else 2
    _, hist = train(
        MODEL, sgd(0.05), client_batches(_source(), 4 * ls, seed=0),
        TrainConfig(steps=3 * ls, algorithm=alg, lr=0.05, local_steps=ls,
                    log_every=1, device="cpu", prefetch=2,
                    schedule=ScheduleConfig(**SCHED)),
        M, log=lambda _: None, init_state=state_from_jax(alg, state_j, "cpu", CFG))
    assert len(hist) == len(hist_j) == 3
    scale = max(1.0, max(abs(e["loss"]) for e in hist_j))
    for a, b in zip(hist, hist_j):
        assert (a["step"], a["round"], a["participants"]) == (
            b["step"], b["round"], b["participants"])
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * scale, (a, b)
