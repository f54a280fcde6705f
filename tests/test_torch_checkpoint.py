"""The port's checkpoints (train/checkpoint.py, utils/msgpack_codec.py)
against the reference's file format.

  * the codec emits the bytes `msgpack.packb(obj, use_bin_type=True)`
    emits, on hypothesis-drawn trees, and reads them back as
    `msgpack.unpackb(raw=False, strict_map_key=False)` does;
  * an Algorithm state round-trips through the port's save / load bit for
    bit, for all seven algorithms (the twin of
    tests/test_algorithms.py::test_algorithm_state_checkpoint_roundtrip),
    and stays trainable and evaluable; a wrong algorithm is refused;
  * across packages: a reference file loads in the port equal to
    `state_from_jax` of the reference's state, and a port file loads in
    the reference equal to `state_to_reference` of the port's, bit for
    bit, for mtsl (SGD, and AdamW on an LM whose server stacks a repeated
    segment), fedem, parallelsfl (its cidx) and smofi;
  * the port's file of the smoke paper-mlp mtsl state and of the smoke
    mamba2-130m {"params", "step"} tree is byte-identical to the
    reference's.
"""
import functools

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jax_opt
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.core.mtsl import TrainState, init_state
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import AdamState
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import stage_batch
from repro_torch.utils import msgpack_codec
from repro_torch.utils.convert import (
    params_to_reference,
    state_from_jax,
    state_to_reference,
)
from repro_torch.utils.tree import tree_leaves_with_path

ALL_ALGS = ["mtsl", "splitfed", "fedavg", "fedem", "fedprox", "parallelsfl",
            "smofi"]
CROSS = ["mtsl", "fedem", "parallelsfl", "smofi"]

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2**63), max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_trees = st.recursive(
    _scalars,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_trees)
def test_codec_matches_msgpack(tree):
    raw = msgpack.packb(tree, use_bin_type=True)
    assert msgpack_codec.packb(tree) == raw
    assert msgpack_codec.unpackb(raw) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 15, 16, 255, 256, 65535, 65536])
def test_codec_headers_at_the_size_limits(n):
    """Every header family at each boundary of its forms."""
    for obj in ("x" * n, b"y" * n, [1] * n, {str(i): 0 for i in range(n)}):
        raw = msgpack.packb(obj, use_bin_type=True)
        assert msgpack_codec.packb(obj) == raw
        assert msgpack_codec.unpackb(raw) == msgpack.unpackb(raw, raw=False)


@functools.lru_cache(maxsize=None)
def _mlp():
    cfg = get_config("paper-mlp", smoke=True)
    src = MultiTaskImageSource(num_classes=cfg.num_clients,
                               image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    return cfg, build_model(cfg), src


def _same(a, b):
    """Two trees (tensors or arrays) equal bit for bit, paths included."""
    la, lb = dict(tree_leaves_with_path(_plain(a))), dict(tree_leaves_with_path(_plain(b)))
    assert sorted(la) == sorted(lb)
    for p in la:
        x, y = _np(la[p]), _np(lb[p])
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert np.array_equal(x, y), p


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _plain(tree):
    """NamedTuples and tuples as lists (tree_leaves_with_path walks dicts
    and lists)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


@pytest.mark.parametrize("alg", ALL_ALGS)
def test_algorithm_state_checkpoint_roundtrip(alg, tmp_path):
    cfg, model, src = _mlp()
    M = cfg.num_clients
    a = get_algorithm(alg)
    hp = HParams(lr=0.1, local_steps=2)
    state = a.init_state(model, torch.Generator().manual_seed(0), M, hp)
    batch = stage_batch(next(client_batches(src, 4 * a.steps_per_round(hp),
                                            seed=0)), "cpu")
    state, _ = a.round_fn(model, M, hp)(state, batch)

    path = str(tmp_path / f"{alg}.msgpack")
    ckpt.save_algorithm_state(path, a, state, extra={"step": 2}, cfg=cfg)
    restored, name, extra = ckpt.load_algorithm_state(path, cfg=cfg)
    assert name == alg and extra == {"step": 2}
    _same(state, restored)
    # the restored state is directly trainable and evaluable
    restored, _ = a.round_fn(model, M, hp)(restored, batch)
    test = stage_batch(next(client_batches(src, 8, seed=5)), "cpu")
    acc = a.eval_fn(model, M)(restored, test)
    assert 0.0 <= float(acc["acc_mtl"]) <= 1.0
    with pytest.raises(ValueError, match="was written by"):
        wrong = [x for x in ("mtsl", "fedavg") if x != alg][0]
        ckpt.load_algorithm_state(path, wrong, cfg=cfg)


@functools.lru_cache(maxsize=None)
def _reference_state(alg):
    """A reference state of smoke paper-mlp as numpy (mtsl with AdamW moments
    filled at random, so no moment is zero)."""
    cfg = jax_get_config("paper-mlp", smoke=True)
    model = jax_build_model(cfg)
    hp = jax_alg.HParams(lr=0.1, local_steps=2)
    state = jax_alg.get_algorithm(alg).init_state(model, jax.random.PRNGKey(1),
                                                  cfg.num_clients, hp)
    return jax.tree.map(np.asarray, state)


def _random_adam(params_ref, seed):
    rng = np.random.default_rng(seed)
    fill = lambda x: rng.normal(size=x.shape).astype(np.float32)  # noqa: E731
    return jax_opt.AdamState(mu=jax.tree.map(fill, params_ref),
                             nu=jax.tree.map(lambda x: np.abs(fill(x)), params_ref))


@pytest.mark.parametrize("alg", CROSS)
def test_reference_file_loads_in_the_port(alg, tmp_path):
    cfg = get_config("paper-mlp", smoke=True)
    state_j = _reference_state(alg)
    path = str(tmp_path / "ref.msgpack")
    jax_ckpt.save_algorithm_state(path, alg, state_j, extra={"step": 4, "round": 2})
    state, name, extra = ckpt.load_algorithm_state(path, alg, cfg=cfg)
    assert name == alg and extra == {"step": 4, "round": 2}
    _same(state, state_from_jax(alg, state_j, "cpu", cfg))
    # and back: the port writes the reference's file
    port_path = str(tmp_path / "port.msgpack")
    ckpt.save_algorithm_state(port_path, alg, state, extra=extra, cfg=cfg)
    with open(path, "rb") as f, open(port_path, "rb") as g:
        assert f.read() == g.read()


@functools.lru_cache(maxsize=None)
def _lm():
    """Smoke mamba2-130m with 6 layers under scan_layers: the server's
    segment repeats, so the reference stacks it along a layer axis."""
    kw = {"num_layers": 6, "split_layers": 2, "scan_layers": True}
    cfg = get_config("mamba2-130m", smoke=True).with_updates(**kw)
    return cfg, build_model(cfg)


def _port_state(alg):
    if alg == "mtsl":  # AdamW on the LM, moments advanced off zero
        cfg, model = _lm()
        params = init_state(model, torch.Generator().manual_seed(2), cfg.num_clients)
        opt = adamw(1e-3)
        moments = opt.init(params)
        gen = torch.Generator().manual_seed(3)
        for t in moments.mu, moments.nu:
            for _, x in tree_leaves_with_path(t):
                x.copy_(torch.rand(x.shape, generator=gen))
        return cfg, TrainState(params, AdamState(moments.mu, moments.nu), 7)
    cfg, model, _ = _mlp()
    hp = HParams(lr=0.1, local_steps=2)
    return cfg, get_algorithm(alg).init_state(
        model, torch.Generator().manual_seed(2), cfg.num_clients, hp)


@pytest.mark.parametrize("alg", CROSS)
def test_port_file_loads_in_the_reference(alg, tmp_path):
    cfg, state = _port_state(alg)
    path = str(tmp_path / "port.msgpack")
    ckpt.save_algorithm_state(path, alg, state, extra={"step": 7, "round": 7},
                              cfg=cfg)
    restored, name, extra = jax_ckpt.load_algorithm_state(path, alg)
    assert name == alg and extra == {"step": 7, "round": 7}
    want = state_to_reference(alg, state, cfg)
    _same(jax.tree.map(np.asarray, restored), want)
    if alg == "mtsl":
        assert type(restored).__module__ == "repro.core.mtsl"
        assert isinstance(restored.opt_state, jax_opt.AdamState)
        # the reference's stacked segment, unstacked again by the port
        assert np.asarray(restored.params["server"]["blocks"]["seg0"]["0"]["mamba"][
            "wx"]).shape[0] == 4
        _same(state_from_jax(alg, jax.tree.map(np.asarray, restored), "cpu", cfg),
              state)


def test_mtsl_sgd_state_bytes_equal_the_reference(tmp_path):
    cfg = get_config("paper-mlp", smoke=True)
    state_j = _reference_state("mtsl")
    assert state_j.opt_state == ()
    a, b = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    jax_ckpt.save_algorithm_state(a, "mtsl", state_j, extra={"step": 1, "round": 1})
    ckpt.save_algorithm_state(b, "mtsl", state_from_jax("mtsl", state_j, "cpu", cfg),
                              extra={"step": 1, "round": 1}, cfg=cfg)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_mtsl_adamw_reference_file_loads_in_the_port(tmp_path):
    """A reference mtsl state with AdamW moments: the port's load equals
    state_from_jax, moments f32 and the step an int."""
    cfg = get_config("paper-mlp", smoke=True)
    s = _reference_state("mtsl")
    state_j = s._replace(opt_state=_random_adam(s.params, 4),
                         step=np.asarray(5, np.int32))
    path = str(tmp_path / "ref.msgpack")
    jax_ckpt.save_algorithm_state(path, "mtsl", state_j)
    state, _, _ = ckpt.load_algorithm_state(path, "mtsl", cfg=cfg)
    assert isinstance(state.opt_state, AdamState) and state.step == 5
    _same(state, state_from_jax("mtsl", state_j, "cpu", cfg))


def test_lm_params_file_bytes_equal_the_reference(tmp_path):
    """The LM example's {"params", "step"} file of smoke mamba2-130m."""
    cfg = get_config("mamba2-130m", smoke=True)
    model = build_model(cfg)
    params = init_state(model, torch.Generator().manual_seed(5), cfg.num_clients)
    tree = params_to_reference(params, cfg)
    a, b = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    jax_ckpt.save_checkpoint(a, {"params": jax.tree.map(jnp.asarray, tree), "step": 3})
    ckpt.save_checkpoint(b, {"params": tree, "step": 3})
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    loaded = ckpt.load_checkpoint(a)
    assert loaded["step"] == 3
    _same(loaded["params"], tree)


def test_bfloat16_and_namedtuple_paths():
    """A bfloat16 leaf keeps its bits; a NamedTuple's path is written as the
    reference's module and resolves to the port's class, and a path with no
    counterpart degrades to a plain tuple."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    tree = {"b": x, "a": TrainState({"w": np.arange(4, dtype=np.int32)}, (), 2)}
    packed = ckpt._pack(tree)
    assert list(packed) == ["a", "b"]
    assert packed["a"]["__namedtuple__"] == "repro.core.mtsl:TrainState"
    assert packed["b"]["dtype"] == "bfloat16"
    back = ckpt._unpack(msgpack.unpackb(msgpack_codec.packb(packed), raw=False))
    assert isinstance(back["a"], TrainState) and back["a"].step == 2
    assert torch.equal(back["b"].view(torch.int16), x.view(torch.int16))
    gone = dict(packed["a"], __namedtuple__="repro.core.nowhere:Gone")
    assert type(ckpt._unpack(gone)) is tuple
