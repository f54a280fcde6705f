"""The engines' compiled steps (`serve/graphs.py`) on the CPU, where each
step runs eagerly on the same static buffers that the card captures.

  * The continuous engine (decode step and one extend step per client over
    static buffers, the chunk's facts as device scalars) against the
    reference's ContinuousEngine, greedy, on the smoke configs of a dense,
    an ssm, a hybrid and an moe arch: 7 mixed-length requests over 2 slots
    at chunk 4 (multi-chunk prefill, eviction, slot reuse) give the
    reference's tokens, and the steps built stay M + 1 however many
    requests stream through (the twin of the reference's
    tests/test_serve_continuous.py, which pins each jit cache at one).
  * Sampled tokens are reproducible across slot counts and equal those
    that the engine sampled before its steps moved onto static buffers
    (its host-side sampling flag and Python-int extend), recorded below
    for the same seeds and keys.
  * tower_extend / server_extend with start and n_valid as device tensors
    equal the Python-int path: bit for bit on one row, and a batch of rows
    with per-row [B] tensors equals each row alone.
  * The sequential engine: a second generate_sequential of the same batch
    shape builds no step, a new shape builds one, and the tokens equal the
    reference's on the VLM, whisper and ring caches.
  * The counter helper: a warm-up counts nothing and runs with the MoE
    tally off, a capture records the step's counts once, and every replay
    adds them once (a replay runs no Python). It adds every Python counter
    of the port, each registered where it is kept (`kernels/counts.py`);
    K3 and K4 keep none: their launches count themselves on the card, in a
    table whose address never changes.
"""
import contextlib
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ssm_serving as S
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve.continuous import ContinuousEngine as JaxContinuousEngine
from repro.serve.continuous import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.core.split import client_view
from repro_torch.kernels import counts
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_reference
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch import serve
from repro_torch.models import build_model, layers, moe
from repro_torch.serve import graphs
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import params_to_reference
from repro_torch.utils.tree import tree_leaves, tree_map

CONT_ARCHS = ["gemma3-12b", "mamba2-130m", "zamba2-7b", "deepseek-moe-16b"]
LENS = [3, 9, 5, 12, 4, 7, 2]
NEW = [5, 3, 6, 2, 4, 5, 3]
MAX_LEN = 20


def _requests(cfg, seed=21):
    rng = np.random.default_rng(seed)
    M = cfg.num_clients
    return [dict(id=i, client=i % M, tokens=rng.integers(0, cfg.vocab_size, size=L),
                 new_tokens=n) for i, (L, n) in enumerate(zip(LENS, NEW))]


@functools.lru_cache(maxsize=None)
def _reference_continuous(arch):
    cfg, model, params = S._reference(arch)
    eng = JaxContinuousEngine(model, params, cfg.num_clients, MAX_LEN, slots=2,
                              chunk=4)
    for r in _requests(cfg):
        eng.submit(JaxRequest(**r))
    res = eng.run()
    return [np.asarray(res[i]) for i in range(len(LENS))]


@pytest.mark.parametrize("arch", CONT_ARCHS)
def test_continuous_steps_match_reference_and_stay_built(arch):
    cfg, model, params = S._port(arch)
    M = cfg.num_clients
    eng = ContinuousEngine(model, params, M, MAX_LEN, slots=2, chunk=4,
                           device="cpu")
    built = (eng.stats["steps"], len(eng._extend_steps))
    assert built == (M + 1, M) and eng.stats["captures"] == 0  # eager on the CPU
    for r in _requests(cfg):
        eng.submit(Request(**r))
    res = eng.run()
    for i, want in enumerate(_reference_continuous(arch)):
        np.testing.assert_array_equal(res[i], want)
    # a second stream of requests through the same engine
    for r in _requests(cfg, seed=22):
        eng.submit(Request(**dict(r, id=r["id"] + 100)))
    assert len(eng.run()) == len(LENS)
    assert eng.stats["admitted"] == 2 * len(LENS) and eng.logits_finite()
    assert (eng.stats["steps"], len(eng._extend_steps)) == built
    assert eng.graphs.steps == M + 1


# each request's sampled tokens from the engine before its steps moved
# onto static buffers (a host-side sampling flag, a Python-int extend), for
# these seeds, keys and temperatures: the static-buffer steps sample the
# same tokens
BEFORE_STATIC_SAMPLED = {
    "gemma3-12b": {0: [70, 70, 70, 70, 70, 70], 1: [297, 189, 284, 222],
                   2: [82, 365, 373, 358, 160], 3: [357, 419, 293],
                   4: [411, 294, 371, 176, 452, 184, 292]},
    "mamba2-130m": {0: [483, 507, 166, 38, 30, 98], 1: [297, 30, 284, 252],
                    2: [258, 315, 373, 502, 444], 3: [357, 117, 318],
                    4: [269, 338, 371, 176, 452, 184, 292]},
}


def _sampled(arch, slots):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    M = cfg.num_clients
    params = serve.init_params(model, M, 3, "cpu")
    rng = np.random.default_rng(5)
    eng = ContinuousEngine(model, params, M, MAX_LEN, slots=slots, chunk=4,
                           seed=11, device="cpu")
    for i, (L, n) in enumerate(zip([3, 7, 10, 5, 4], [6, 4, 5, 3, 7])):
        eng.submit(Request(id=i, client=i % M, new_tokens=n,
                           tokens=rng.integers(0, cfg.vocab_size, size=L),
                           temperature=[0.0, 0.7, 1.3, 0.9, 2.0][i]))
    return eng.run()


@pytest.mark.parametrize("arch", sorted(BEFORE_STATIC_SAMPLED))
def test_sampled_tokens_reproducible_and_unchanged(arch):
    a, b = _sampled(arch, 3), _sampled(arch, 2)
    for i, want in BEFORE_STATIC_SAMPLED[arch].items():
        assert a[i].tolist() == want
        assert b[i].tolist() == want


@functools.lru_cache(maxsize=None)
def _extend_inputs(arch):
    """A 3-row pool whose caches hold a prompt per row, and a chunk."""
    cfg, model, params = S._port(arch)
    tp, sp = client_view(params["towers"], 1), params["server"]
    C, cap = 4, 16
    rng = np.random.default_rng(9)
    tc, sc = model.init_tower_cache(3, cap, "cpu"), model.init_server_cache(3, cap, "cpu")
    with torch.no_grad():
        pre = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(3, 4)))
        sm = model.tower_extend(tp, {"tokens": pre}, tc, 0, 4)
        model.server_extend(sp, sm, sc, 0, 4)
    chunk = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(3, C)))
    return model, tp, sp, tc, sc, chunk


def _extend(model, tp, sp, tc, sc, tokens, start, n_valid):
    tc, sc = tree_map(torch.clone, tc), tree_map(torch.clone, sc)
    with torch.no_grad():
        sm = model.tower_extend(tp, {"tokens": tokens}, tc, start, n_valid)
        logits = model.server_extend(sp, sm, sc, start, n_valid)
    return logits, tree_leaves(tc) + tree_leaves(sc)


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-130m", "zamba2-7b"])
def test_extend_with_device_scalars_equals_python_ints(arch):
    model, tp, sp, tc, sc, chunk = _extend_inputs(arch)
    one = lambda t: tree_map(lambda x: x[1:2], t)  # noqa: E731
    # one row: 0-dim tensors against ints, bit for bit
    want = _extend(model, tp, sp, one(tc), one(sc), chunk[1:2], 4, 3)
    got = _extend(model, tp, sp, one(tc), one(sc), chunk[1:2],
                  torch.tensor(4), torch.tensor(3))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    # three rows at their own start and n_valid, against each row alone
    starts, valid = [4, 2, 0], [3, 4, 1]
    got = _extend(model, tp, sp, tc, sc, chunk, torch.tensor(starts),
                  torch.tensor(valid, dtype=torch.int32))
    for r in range(3):
        rows = lambda t: tree_map(lambda x: x[r:r + 1], t)  # noqa: E731
        want = _extend(model, tp, sp, rows(tc), rows(sc), chunk[r:r + 1],
                       starts[r], valid[r])
        np.testing.assert_allclose(got[0][r].numpy(), want[0][0].numpy(),
                                   atol=1e-5, rtol=1e-5)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a[r].numpy(), b[0].numpy(), atol=1e-5,
                                       rtol=1e-5)


RING = dict(sliding_window=8, decode_long_window=8, attn_pattern=("swa",),
            num_layers=2, split_layers=1)
SEQ_CASES = {  # name: (arch, config updates, prompt, new tokens)
    "vlm": ("llama-3.2-vision-11b", {}, 7, 5),
    "whisper": ("whisper-tiny", {}, 7, 5),
    "ring": ("gemma3-12b", RING, 12, 8),
}


@functools.lru_cache(maxsize=None)
def _sequential_setup(name):
    arch, upd, L, n = SEQ_CASES[name]
    cfg = get_config(arch, smoke=True).with_updates(**upd)
    model = build_model(cfg)
    M = cfg.num_clients
    params = serve.init_params(model, M, 4, "cpu")
    inputs = serve.seeded_inputs(cfg, M, 2, L, 11)
    cfg_j = jax_get_config(arch, smoke=True).with_updates(**upd)
    tree = jax.tree.map(jnp.asarray, params_to_reference(params, cfg))
    eng = JaxServeEngine(jax_build_model(cfg_j), tree, M, L + n)
    want = np.asarray(eng.generate_sequential(jax.tree.map(jnp.asarray, inputs), n))
    return cfg, model, params, inputs, want


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_sequential_steps_built_once_per_shape(name):
    cfg, model, params, inputs, want = _sequential_setup(name)
    L, n = SEQ_CASES[name][2:]
    eng = ServeEngine(model, params, cfg.num_clients, L + n, device="cpu")
    first = eng.generate_sequential(inputs, n)
    assert eng.graphs.steps == 1 and len(eng._buffers) == 1
    np.testing.assert_array_equal(first.numpy(), want)
    second = eng.generate_sequential(inputs, n)
    assert eng.graphs.steps == 1 and eng.graphs.captures == 0
    assert torch.equal(first, second)
    # another batch shape: one more step, the first one's tokens unchanged
    one = {k: v[:, :1] for k, v in inputs.items()}
    np.testing.assert_array_equal(eng.generate_sequential(one, n).numpy(),
                                  want[:, :1])
    assert eng.graphs.steps == 2


def test_dropped_engines_are_freed_at_once():
    """The steps hold no reference back to their engine: an engine that no
    caller holds is freed by reference counting alone, with its caches and
    graphs, before the next model is built."""
    cfg, model, params = S._port("zamba2-7b")
    M = cfg.num_clients
    gc.disable()
    try:
        eng = ContinuousEngine(model, params, M, MAX_LEN, slots=2, chunk=4,
                               device="cpu")
        eng.submit(Request(**_requests(cfg)[0]))
        eng.run()
        seq = ServeEngine(model, params, M, MAX_LEN, device="cpu")
        seq.generate_sequential({"tokens": np.ones((M, 1, 5), np.int64)}, 3)
        seq.generate({"tokens": np.ones((M, 1, 5), np.int64)}, 3)
        refs = [weakref.ref(e) for e in (eng, seq, seq._cont[(1, 5)])]
        del eng, seq
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


class _Replay:
    """A captured graph as far as Python sees it: replay runs nothing."""

    def replay(self):
        pass


@contextlib.contextmanager
def _null(*args, **kwargs):
    yield


def test_counts_added_once_per_replay_and_no_warm_up(monkeypatch):
    seen = []

    def fn():  # one step: two K2 launches, two decode attentions, one plain decode
        flash_attention.launches += 2
        layers.attn_decode.calls += 2
        decode_reference.cuda_calls += 1
        seen.append(moe.moe_forward.tally)
        return "logits"

    class _Stream:
        device = "cpu"

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", _null)
    monkeypatch.setattr(torch.cuda, "graph", _null)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Replay)
    tally = torch.zeros(2, dtype=torch.int64)
    monkeypatch.setattr(moe.moe_forward, "tally", tally)
    before = graphs.read_counts()
    graph, out, delta = graphs.capture(fn, None, _Stream())
    # the warm-up ran with the tally off, the capture with it on; neither
    # is counted
    assert seen == [None, tally] and graphs.read_counts() == before
    assert out == "logits" and sum(delta) == 5
    step = graphs.Step(fn, graph, out, delta)
    n_k2, n_calls, n_plain = (flash_attention.launches, layers.attn_decode.calls,
                              decode_reference.cuda_calls)
    for _ in range(3):
        assert step.run() == "logits"
    assert len(seen) == 2  # no Python ran on replay
    assert flash_attention.launches == n_k2 + 6
    assert layers.attn_decode.calls == n_calls + 6
    assert decode_reference.cuda_calls == n_plain + 3
    # an uncaptured step counts by running
    eager = graphs.Step(fn)
    eager.run()
    assert flash_attention.launches == n_k2 + 8 and eager.graph is None


def test_every_python_counter_is_registered():
    """Every int counter that a function of the kernels or the layers
    keeps is one that a replay adds; K3 and K4 keep none in Python."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels

    kept = set()
    mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        kernels.__path__, "repro_torch.kernels.")] + [layers]
    for mod in mods:
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                kept |= {(fn, a) for a, v in vars(fn).items()
                         if type(v) is int and not a.startswith("_")}
    assert kept and kept <= set(counts.REGISTERED)
    assert (layers.attn_decode, "calls") in kept
    for fn in (flash_decode, ssd_scan):
        assert not any(f is fn for f, _ in counts.REGISTERED)
        assert isinstance(fn.counts, counts.DeviceCounts)


@pytest.fixture
def device_counts():
    """A kernel's launch counts with a table on the CPU standing in for
    the card's, taken out of the registry afterwards."""
    c = counts.DeviceCounts("k", ("a", "b"))
    yield c
    counts.DEVICE.remove(c)


def test_device_counts_keep_their_table(device_counts):
    """A graph launches on the entry's address it captured: the table is
    made once per device, zeroed and restored in place, and read by key."""
    c, cpu = device_counts, torch.device("cpu")
    assert c.read() == {"a": 0, "b": 0}  # no table yet: nothing launched
    a, b = c.entry(cpu, "a"), c.entry(cpu, "b")
    assert b - a == 8 and c.entry(cpu, "a") == a
    table = c._tables[cpu]
    table += torch.tensor([2, 5])
    assert c.read() == {"a": 2, "b": 5} and c.total() == 7
    saved = c.save()
    table += 1
    c.restore(saved)
    assert c.read() == {"a": 2, "b": 5}
    c.reset()
    assert c.read() == {"a": 0, "b": 0} and c._tables[cpu] is table
    assert c.entry(cpu, "b") == b


def test_warm_up_takes_back_the_launches_counted_on_the_card(device_counts):
    """A step's warm-up launches its kernels for real, and they count
    themselves; the warm-up is not a step served, so its counts are put
    back, a table that the warm-up made included."""
    c, cpu = device_counts, torch.device("cpu")
    made = counts.DeviceCounts("new", ("x",))
    try:
        c.entry(cpu, "a")
        c._tables[cpu] += torch.tensor([3, 0])

        def fn():  # two launches, one on a table that did not exist
            c._tables[cpu] += torch.tensor([1, 1])
            made.entry(cpu, "x")
            made._tables[cpu] += 1

        graphs._warm_up(fn)
        assert c.read() == {"a": 3, "b": 0} and made.read() == {"x": 0}
    finally:
        counts.DEVICE.remove(made)
