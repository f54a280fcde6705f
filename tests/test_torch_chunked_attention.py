"""attn_impl="chunked" in the port against the reference, on the CPU.

  * `mha_chunked` (kernels/flash_attention/ref.py) against the reference's
    over tests/test_kernels.py's chunked cases: forward within 2e-5 and
    the gradients of sum(out * g) within 1e-4 of max(1, |g|);
  * `attn_forward` (causal with a window, non-causal, cross) and
    `attn_prefill` (its output and its cache, full and ring) under
    "chunked" against the reference's, the same tolerances;
  * the sequential engine's greedy tokens under "chunked" against the
    reference's (gemma3-12b smoke, f32), equal;
  * on meta tensors a chunked prefill goes through K2's cost model (the
    dry-run's), once a layer, and the plain version is not called.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.split import stack_towers as jax_stack_towers
from repro.kernels.flash_attention.ref import mha_chunked as jax_mha_chunked
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.utils.sharding import strip
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.kernels.counts import META
from repro_torch.kernels.flash_attention.ops import attention_cost, flash_attention
from repro_torch.kernels.flash_attention.ref import mha_chunked, mha_reference
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import convert_tree, params_from_jax
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

TOL, GTOL = 2e-5, 1e-4
# tests/test_kernels.py's chunked cases: (B, Sq, Sk, Hq, Hkv, D, causal,
# window, chunk)
CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 16),
    (1, 96, 96, 4, 1, 16, True, 24, 32),
    (2, 32, 32, 8, 4, 32, False, 0, 8),
]
ARCH = "gemma3-12b"
CHUNKED = {"attn_impl": "chunked", "attn_chunk": 8, "dtype": "float32"}


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _grad_close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= GTOL * scale, (err, scale)


def _check(fn_j, pj, fn_t, pt, inputs, g):
    """fn(p, *inputs) forward within TOL and the gradients of sum(fn * g)
    with respect to the params and every input within GTOL."""
    ja = [jnp.asarray(a) for a in inputs]
    want, vjp = jax.vjp(fn_j, pj, *ja)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn_t(pt, *ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    grads = vjp(jnp.asarray(g))
    (out * torch.tensor(g)).sum().backward()
    for t, w in zip(ts, grads[1:]):
        _grad_close(t.grad, w)
    if pj is not None:
        flat = flatten_dict(grads[0])
        for path, leaf in tree_leaves_with_path(pt):
            _grad_close(leaf.grad, flat[path])


@pytest.mark.parametrize("case", CASES)
def test_mha_chunked_matches_reference(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, chunk = case
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, B, Sq, Hq, D), _rand(rng, B, Sk, Hkv, D), _rand(rng, B, Sk, Hkv, D)
    g = _rand(rng, B, Sq, Hq, D)
    kw = dict(causal=causal, window=window, chunk=chunk)
    _check(jax.jit(lambda _, q, k, v: jax_mha_chunked(q, k, v, **kw)), None,
           lambda _, q, k, v: mha_chunked(q, k, v, **kw), None, [q, k, v], g)
    # the wrapper's plain version under a chunk is mha_chunked, uncounted
    t = [torch.tensor(a) for a in (q, k, v)]
    n0 = flash_attention.launches
    got = flash_attention(*t, causal=causal, window=window, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), mha_chunked(*t, **kw).numpy())
    assert flash_attention.launches == n0
    # the same function as the unchunked attention
    np.testing.assert_allclose(got.numpy(), mha_reference(
        *t, causal=causal, window=window).numpy(), atol=TOL, rtol=TOL)


def _cfgs(**kw):
    upd = {**CHUNKED, **kw}
    return (jax_get_config(ARCH, smoke=True).with_updates(**upd),
            get_config(ARCH, smoke=True).with_updates(**upd))


def _attn_params(cfg_j, cfg, cross=False):
    pj = strip(JL.attn_params(jax.random.PRNGKey(3), cfg_j, cross=cross))
    pt = tree_map(lambda x: x.requires_grad_(),
                  convert_tree(jax.tree.map(np.asarray, pj), "cpu", cfg))
    return pj, pt


@pytest.mark.parametrize("mode", ["causal-window", "bidir", "cross"])
def test_attn_forward_chunked_matches_reference(mode):
    cfg_j, cfg = _cfgs()
    pj, pt = _attn_params(cfg_j, cfg, cross=mode == "cross")
    rng = np.random.default_rng(1)
    x, kv = _rand(rng, 2, 24, cfg.d_model), _rand(rng, 2, 17, cfg.d_model)
    g = _rand(rng, 2, 24, cfg.d_model)
    if mode == "causal-window":
        w = 10
        _check(jax.jit(lambda p, x: JL.attn_forward(p, x, cfg_j, window=w)), pj,
               lambda p, x: TL.attn_forward(p, x, cfg, window=w), pt, [x], g)
    elif mode == "bidir":
        _check(jax.jit(lambda p, x: JL.attn_forward(p, x, cfg_j, causal=False)), pj,
               lambda p, x: TL.attn_forward(p, x, cfg, causal=False), pt, [x], g)
    else:
        _check(jax.jit(lambda p, x, kv: JL.attn_forward(p, x, cfg_j, kv_src=kv)), pj,
               lambda p, x, kv: TL.attn_forward(p, x, cfg, kv_src=kv), pt, [x, kv], g)


@pytest.mark.parametrize("window,max_len,ring", [(0, 32, 0), (10, 32, 0), (10, 32, 1),
                                                 (16, 32, 1)])
def test_attn_prefill_chunked_matches_reference(window, max_len, ring):
    cfg_j, cfg = _cfgs(decode_long_window=ring)
    pj, pt = _attn_params(cfg_j, cfg)
    x = _rand(np.random.default_rng(2), 2, 21, cfg.d_model)
    y_j, c_j = jax.jit(lambda p, x: JL.attn_prefill(p, x, cfg_j, window=window,
                                                    max_len=max_len))(pj, jnp.asarray(x))
    with torch.no_grad():
        y, c = TL.attn_prefill(pt, torch.tensor(x), cfg, window=window, max_len=max_len)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        assert c[key].shape == c_j[key].shape
        np.testing.assert_allclose(c[key].numpy(), np.asarray(c_j[key]), atol=TOL, rtol=TOL)


def test_chunked_prefill_on_meta_goes_through_k2_cost_model():
    _, cfg = _cfgs()
    p = tree_map(lambda t: t.to("meta"), TL.attn_params(torch.Generator(), cfg))
    x = torch.empty(2, 40, cfg.d_model, device="meta")
    META.reset()
    calls = mha_reference.cuda_calls
    with torch.no_grad():
        y, _ = TL.attn_prefill(p, x, cfg, window=16, max_len=48)
    assert y.is_meta and y.shape == x.shape
    got = META.by_kernel["flash_attention"]
    want = attention_cost(2, 40, 40, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          True, 16, 4)
    assert got["launches"] == 1 and got["flops"] == want.flops and got["bytes"] == want.bytes
    assert mha_reference.cuda_calls == calls
    META.reset()


PROMPT_LENS, NEW_TOKENS, MAX_LEN = [11, 6, 17], [5, 7, 4], 24


@functools.lru_cache(maxsize=None)
def _models():
    cfg_j, cfg = _cfgs()
    model_j = jax_build_model(cfg_j)
    params_j = jax.jit(lambda r: strip({
        "towers": jax_stack_towers(model_j.init_tower, r, cfg_j.num_clients),
        "server": model_j.init_server(jax.random.fold_in(r, 1))}))(jax.random.PRNGKey(7))
    params = params_from_jax(jax.tree.map(np.asarray, params_j), "cpu", cfg)
    return (cfg_j, model_j, params_j), (cfg, build_model(cfg), params)


def _rows(cfg, p):
    toks = np.zeros((cfg.num_clients, 1, len(p)), np.int32)
    toks[:, 0] = p
    return toks


def test_sequential_engine_greedy_tokens_chunked():
    (cfg_j, model_j, params_j), (cfg, model, params) = _models()
    rng = np.random.default_rng(50)
    prompts = [rng.integers(0, cfg.vocab_size, size=L) for L in PROMPT_LENS]
    ref = JaxServeEngine(model_j, params_j, cfg.num_clients, MAX_LEN)
    eng = ServeEngine(model, params, cfg.num_clients, MAX_LEN, device="cpu")
    for p, n in zip(prompts, NEW_TOKENS):
        want = np.asarray(ref.generate_sequential(
            {"tokens": jnp.asarray(_rows(cfg, p))}, new_tokens=n))
        got = eng.generate_sequential({"tokens": _rows(cfg, p)}, n)
        np.testing.assert_array_equal(got.numpy(), want)
