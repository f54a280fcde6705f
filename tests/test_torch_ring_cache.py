"""Ring KV caches (`decode_long_window`: a sliding-window layer keeps only
its last `window` keys, position p at slot p % window) of the port against
the JAX reference, in f32 on the gemma3-12b smoke config with every layer
a window-8 `swa` layer, as the reference's
tests/test_decode_consistency.py::test_swa_ring_cache_long_decode builds it.

  * `attn_prefill` for prompts shorter than, equal to and longer than the
    window (zero-padded; filled; the last `window` keys rolled by
    S % window): outputs and caches within 1e-5 of the reference's;
  * `attn_decode` on a ring at per-row positions before and past the
    window (slot pos % cap, min(pos + 1, cap) live slots, no window mask)
    within 1e-5 of the reference's, with the reference's Pallas decode
    kernel off and on (interpret mode), and through K4's "ring" mode;
    frozen rows keep their cache;
  * the twin of test_swa_ring_cache_long_decode: 8 decode steps past the
    window on the ring equal the full-capacity caches' within 3e-5, and
    the ring's logits equal the reference's ring logits within 1e-4;
  * the continuous engine refuses ring caches, `ServeEngine.generate`
    serves them through the sequential engine (no continuous engine is
    built), and `attn_extend` refuses a ring cache, with the reference's
    messages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.core.split import client_view
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.launch.serve import init_params
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import convert_tree, params_to_reference

W = 8
RING = dict(sliding_window=W, decode_long_window=W, attn_pattern=("swa",),
            num_layers=2, split_layers=1)
CFG_T = get_config("gemma3-12b", smoke=True).with_updates(**RING)
CFG_J = jax_get_config("gemma3-12b", smoke=True).with_updates(**RING)
S, T = 12, 8  # decode well past the window


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _attn_params():
    pj = strip(JL.attn_params(jax.random.PRNGKey(3), CFG_J))
    return pj, convert_tree(jax.tree.map(np.asarray, pj), "cpu", CFG_T)


def test_configs_are_copies():
    assert CFG_T.__dict__ == CFG_J.__dict__
    swa_t, swa_j = (get("mistral-nemo-12b-swa") for get in (get_config, jax_get_config))
    assert swa_t.__dict__ == swa_j.__dict__ and swa_t.decode_long_window == 4096


@pytest.mark.parametrize("L", [5, W, 13, 16])
def test_ring_prefill(L):
    pj, pt = _attn_params()
    x = _rand(np.random.default_rng(L), 2, L, CFG_T.d_model)
    yj, cj = jax.jit(functools.partial(JL.attn_prefill, cfg=CFG_J, window=W,
                                       max_len=L + T))(pj, jnp.asarray(x))
    yt, ct = TL.attn_prefill(pt, torch.tensor(x), CFG_T, window=W, max_len=L + T)
    assert ct["k"].shape[1] == W == cj["k"].shape[1]
    _close(yt, yj)
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])
    # the init's cap is the window too; without decode_long_window it is not
    assert TL.init_attn_cache(CFG_T, 1, L + T, "cpu", window=W)["k"].shape[1] == W
    full = CFG_T.with_updates(decode_long_window=0)
    assert TL.init_attn_cache(full, 1, L + T, "cpu", window=W)["k"].shape[1] == L + T


@pytest.mark.parametrize("flash", [False, True])
def test_ring_decode_past_the_window(flash):
    pj, pt = _attn_params()
    rng = np.random.default_rng(7)
    B = 4
    x = _rand(rng, B, 1, CFG_T.d_model)
    k = _rand(rng, B, W, CFG_T.num_kv_heads, CFG_T.head_dim)
    v = _rand(rng, B, W, CFG_T.num_kv_heads, CFG_T.head_dim)
    pos = np.array([0, 5, 8, 21], np.int32)  # before, at and past the window
    cfg_j = CFG_J.with_updates(use_flash_kernel=flash)
    yj, cj = jax.jit(functools.partial(JL.attn_decode, cfg=cfg_j, window=W))(
        pj, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(pos))
    cache = {"k": torch.tensor(k), "v": torch.tensor(v)}
    ring0 = flash_decode.counts.read()["ring"]
    yt = TL.attn_decode(pt, torch.tensor(x), cache, torch.tensor(pos), CFG_T,
                        window=W)
    assert flash_decode.counts.read()["ring"] == ring0  # the CPU path is not counted
    _close(yt, yj)
    _close(cache["k"], cj["k"])
    _close(cache["v"], cj["v"])

    write = torch.tensor([True, False, True, False])
    frozen = {"k": torch.tensor(k), "v": torch.tensor(v)}
    TL.attn_decode(pt, torch.tensor(x), frozen, torch.tensor(pos), CFG_T,
                   window=W, write=write)
    for name, old in (("k", k), ("v", v)):
        torch.testing.assert_close(frozen[name][~write], torch.tensor(old)[~write],
                                   rtol=0, atol=0)
        torch.testing.assert_close(frozen[name][write], cache[name][write],
                                   rtol=0, atol=0)


def test_attn_extend_refuses_a_ring_cache():
    _, pt = _attn_params()
    cache = TL.init_attn_cache(CFG_T, 1, S + T, "cpu", window=W)
    with pytest.raises(ValueError, match="does not support ring KV caches"):
        TL.attn_extend(pt, torch.zeros(1, 4, CFG_T.d_model), cache, 0, CFG_T,
                       window=W)


def _decode_logits(model, tp, sp, toks):
    sm, tc = model.tower_prefill(tp, {"tokens": toks[:, :S]}, S + T)
    lg, sc = model.server_prefill(sp, sm, S + T)
    seq = [lg[:, 0]]
    for t in range(T):
        pos = S + t
        sm_t = model.tower_decode(tp, {"tokens": toks[:, pos:pos + 1]}, tc, pos)
        seq.append(model.server_decode(sp, sm_t, sc, pos)[:, 0])
    return seq, tc


@functools.lru_cache(maxsize=None)
def _weights_and_tokens():
    params = init_params(build_model(CFG_T), CFG_T.num_clients, 5, "cpu")
    toks = np.random.default_rng(3).integers(0, CFG_T.vocab_size, size=(1, S + T))
    return params, toks


@functools.lru_cache(maxsize=None)
def _reference_ring_logits():
    params, toks = _weights_and_tokens()
    tree = jax.tree.map(jnp.asarray, params_to_reference(params, CFG_T))
    tp = jax.tree.map(lambda x: x[0], tree["towers"])
    model = jax_build_model(CFG_J)
    sm, tc = model.tower_prefill(tp, {"tokens": jnp.asarray(toks[:, :S])}, S + T)
    lg, sc = model.server_prefill(tree["server"], sm, S + T)
    seq = [np.asarray(lg[:, 0])]
    for t in range(T):
        pos = S + t
        sm_t, tc = model.tower_decode(tp, {"tokens": jnp.asarray(toks[:, pos:pos + 1])},
                                      tc, pos)
        lg, sc = model.server_decode(tree["server"], sm_t, sc, pos)
        seq.append(np.asarray(lg[:, 0]))
    return np.stack(seq)


def test_ring_long_decode_matches_full_capacity_and_reference():
    params, toks = _weights_and_tokens()
    tp, sp = client_view(params["towers"], 0), params["server"]
    toks = torch.as_tensor(toks)
    with torch.no_grad():
        ring, tc = _decode_logits(build_model(CFG_T), tp, sp, toks)
        full, tc_full = _decode_logits(
            build_model(CFG_T.with_updates(decode_long_window=0)), tp, sp, toks)
    assert tc["seg0"]["0"]["k"].shape[1] == W
    assert tc_full["seg0"]["0"]["k"].shape[1] == S + T
    ring, full = torch.stack(ring), torch.stack(full)
    _close(ring, full.numpy(), tol=3e-5)
    _close(ring, _reference_ring_logits(), tol=1e-4)


def test_engines_route_ring_caches_to_the_sequential_engine():
    params, toks = _weights_and_tokens()
    model = build_model(CFG_T)
    with pytest.raises(ValueError, match="does not support ring KV caches"):
        ContinuousEngine(model, params, CFG_T.num_clients, S + T, device="cpu")
    eng = ServeEngine(model, params, CFG_T.num_clients, S + T, device="cpu")
    batch = {"tokens": np.concatenate([toks[:, :S]] * CFG_T.num_clients)[:, None]}
    got = eng.generate(batch, T)
    assert eng._cont == {}  # no continuous engine was built
    want = eng.generate_sequential(batch, T)
    assert got.shape == (CFG_T.num_clients, 1, T)
    assert torch.equal(got, want)
