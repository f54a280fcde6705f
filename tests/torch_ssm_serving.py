"""Shared by the tests of the port's SSM and hybrid serving paths
(`tests/test_torch_ssm_serving.py`, mamba2-130m, and
`tests/test_torch_hybrid_serving.py`, zamba2-7b): the port against the JAX
reference on an arch's smoke config, in f32. A Mamba block's weights are
initialised in JAX and carried across with `convert_tree`; a whole model's
are drawn by the port and handed to the reference with
`params_to_reference`; inputs come from numpy seeds.

  * the Mamba block's serving functions (prefill, decode, extend with
    padded rows and a nonzero state) hold within 1e-5 of the reference's,
    on the outputs and on every cache leaf; decode honours `write`;
  * prefill + step-by-step decode reproduce the teacher-forced forward's
    logits within 3e-5 (the twin of tests/test_decode_consistency.py);
  * the reference's continuous-batching scenario (3 slots, 5 mixed-length
    requests, chunk 4, M = 2): greedy tokens of the port's ContinuousEngine
    and generate_sequential equal the reference's generate_sequential token
    for token, and the prefill logits agree within 1e-4;
  * after the continuous engine has decoded slots of both clients, each
    slot's SSM state equals the sequential engine's: the engine runs every
    client's tower over all slots, so a decode that ignored `write` would
    advance a row once per client.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import ssm as JS
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.core.split import client_view
from repro_torch.models import build_model
from repro_torch.models import ssm as TS
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.launch.serve import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import convert_tree, params_to_reference
from repro_torch.utils.tree import tree_leaves_with_path

TOL = 1e-5
PROMPT_LENS = [3, 7, 10, 5, 4]
NEW_TOKENS = [6, 4, 5, 3, 7]
MAX_LEN = 20


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _cache_close(got: dict, want: dict, rows=slice(None)):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k][rows], np.asarray(want[k])[rows])


@functools.lru_cache(maxsize=None)
def _block(arch):
    """One Mamba block's params in both packages."""
    cfg_j = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    pj = strip(JS.mamba_params(jax.random.PRNGKey(3), cfg_j))
    # a nonzero A_log, dt_bias and D, so decays and skips are not trivial
    rng = np.random.default_rng(3)
    H = pj["A_log"].shape[0]
    pj = dict(pj, A_log=jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.5),
              dt_bias=jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.5),
              D=jnp.asarray(rng.normal(size=H).astype(np.float32)))
    pt = convert_tree(jax.tree.map(np.asarray, pj), "cpu", cfg)
    return cfg_j, cfg, pj, pt


def _random_cache(cfg, B, seed):
    """A nonzero decode cache (numpy), as a prompt would leave it."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in TS.init_mamba_cache(cfg, B, "cpu").items()}
    return {k: rng.normal(size=s).astype(np.float32) * (0.3 if k == "state" else 1.0)
            for k, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg):
    """The reference's block function under jax.jit (one compile instead of
    one dispatch per eager op)."""
    return jax.jit(functools.partial(fn, cfg=cfg))


def _to_torch(cache):
    return {k: torch.tensor(v) for k, v in cache.items()}


def check_block_prefill(arch):
    """mamba_prefill's output and cache; mamba_forward from an initial
    state."""
    cfg_j, cfg, pj, pt = _block(arch)
    x = np.random.default_rng(0).normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    y_j, c_j = _jit(JS.mamba_prefill, cfg_j)(pj, jnp.asarray(x))
    y_t, c_t = TS.mamba_prefill(pt, torch.tensor(x), cfg)
    _close(y_t, y_j)
    _cache_close(c_t, c_j)
    # the forward resumed from a state, returning the final one
    h0 = _random_cache(cfg, 2, 4)["state"]
    fwd = _jit(functools.partial(JS.mamba_forward, return_state=True), cfg_j)
    y_j, s_j = fwd(pj, jnp.asarray(x), initial_state=jnp.asarray(h0))
    y_t, s_t = TS.mamba_forward(pt, torch.tensor(x), cfg, return_state=True,
                                initial_state=torch.tensor(h0))
    _close(y_t, y_j)
    _close(s_t, s_j)


def check_block_decode(arch):
    cfg_j, cfg, pj, pt = _block(arch)
    B = 3
    cache = _random_cache(cfg, B, 1)
    x = np.random.default_rng(1).normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    y_j, c_j = _jit(JS.mamba_decode, cfg_j)(pj, jnp.asarray(x),
                                           jax.tree.map(jnp.asarray, cache))
    c_t = _to_torch(cache)
    _close(TS.mamba_decode(pt, torch.tensor(x), c_t, cfg), y_j)
    _cache_close(c_t, c_j)
    # a write mask: frozen rows keep their cache bit for bit
    write = torch.tensor([True, False, True])
    c_w = _to_torch(cache)
    _close(TS.mamba_decode(pt, torch.tensor(x), c_w, cfg, write=write), y_j)
    _cache_close(c_w, c_j, rows=write.numpy())
    for k in cache:
        assert np.array_equal(c_w[k][1].numpy(), cache[k][1])


def check_block_extend(arch, C):
    """A chunk of C tokens per row from a nonzero cache, with padded rows
    (n_valid < C), per-row and as one int."""
    cfg_j, cfg, pj, pt = _block(arch)
    B = 3
    cache = _random_cache(cfg, B, 2)
    x = np.random.default_rng(2).normal(size=(B, C, cfg.d_model)).astype(np.float32)
    n_valid = np.array([C, 1, max(C - 2, 1)], np.int32)
    extend = _jit(JS.mamba_extend, cfg_j)
    y_j, c_j = extend(pj, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                      jnp.asarray(n_valid))
    c_t = _to_torch(cache)
    y_t = TS.mamba_extend(pt, torch.tensor(x), c_t, torch.tensor(n_valid), cfg)
    for b, n in enumerate(n_valid):  # padded positions are garbage
        _close(y_t[b, :n], np.asarray(y_j)[b, :n])
    _cache_close(c_t, c_j)
    # an int n_valid (the continuous engine's batch-1 call) on row 2 alone
    n = int(n_valid[2])
    c1_t = {k: torch.tensor(v[2:3]) for k, v in cache.items()}
    y1_t = TS.mamba_extend(pt, torch.tensor(x[2:3]), c1_t, n, cfg)
    _close(y1_t[0, :n], np.asarray(y_j)[2, :n])
    _cache_close(c1_t, {k: np.asarray(v)[2:3] for k, v in c_j.items()})


@functools.lru_cache(maxsize=None)
def _port(arch):
    """The port's model and serving tree (f32 smoke config) from a seed."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    return cfg, model, init_params(model, cfg.num_clients, 7, "cpu")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's model over the port's weights."""
    cfg, _, params = _port(arch)
    cfg_j = jax_get_config(arch, smoke=True)
    assert cfg.__dict__ == cfg_j.__dict__
    return cfg_j, jax_build_model(cfg_j), jax.tree.map(
        jnp.asarray, params_to_reference(params, cfg))


def check_prefill_decode_matches_forward(arch):
    cfg, model, params = _port(arch)
    tp = client_view(params["towers"], 0)
    sp = params["server"]
    B, S, T = 2, 8, 4
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S + T)))
    with torch.no_grad():
        full, _ = model.server_forward(sp, model.tower_forward(tp, {"tokens": toks}))
        h, tcache = model.tower_prefill(tp, {"tokens": toks[:, :S]}, S + T)
        logits, scache = model.server_prefill(sp, h, S + T)
        _close(logits[:, 0], full[:, S - 1].numpy(), tol=3e-5)
        for t in range(T):
            pos = S + t
            h = model.tower_decode(tp, {"tokens": toks[:, pos:pos + 1]}, tcache, pos)
            logits = model.server_decode(sp, h, scache, pos)
            _close(logits[:, 0], full[:, pos].numpy(), tol=3e-5)


def _prompts(cfg):
    rng = np.random.default_rng(50)
    return [rng.integers(0, cfg.vocab_size, size=L) for L in PROMPT_LENS]


def _one_row(cfg, i, p):
    """Request i alone in its client's row (the other client's row is
    zeros), so batching cannot couple requests."""
    toks = np.zeros((cfg.num_clients, 1, len(p)), np.int32)
    toks[i % cfg.num_clients, 0] = p
    return toks


@functools.lru_cache(maxsize=None)
def _reference_outputs(arch):
    """Per-request greedy tokens and prefill logits of the reference's
    generate_sequential."""
    cfg, model, params = _reference(arch)
    eng = JaxServeEngine(model, params, cfg.num_clients, MAX_LEN)
    outs, logits = [], []
    for i, (p, n) in enumerate(zip(_prompts(cfg), NEW_TOKENS)):
        toks = jnp.asarray(_one_row(cfg, i, p))
        outs.append(np.asarray(eng.generate_sequential({"tokens": toks}, n))[
            i % cfg.num_clients, 0])
        lg, _ = eng._prefill(eng.params, {"tokens": toks})
        logits.append(np.asarray(lg))
    return outs, logits


def check_greedy_parity(arch):
    cfg, model, params = _port(arch)
    refs, ref_logits = _reference_outputs(arch)
    eng = ContinuousEngine(model, params, cfg.num_clients, MAX_LEN, slots=3,
                           chunk=4, device="cpu")
    for i, (p, n) in enumerate(zip(_prompts(cfg), NEW_TOKENS)):
        eng.submit(Request(id=i, client=i % cfg.num_clients, tokens=p, new_tokens=n))
    res = eng.run()
    assert eng.stats["admitted"] == len(PROMPT_LENS)
    seq = ServeEngine(model, params, cfg.num_clients, MAX_LEN, device="cpu")
    for i, (p, n) in enumerate(zip(_prompts(cfg), NEW_TOKENS)):
        np.testing.assert_array_equal(res[i], refs[i])
        toks = _one_row(cfg, i, p)
        out = seq.generate_sequential({"tokens": toks}, n)
        np.testing.assert_array_equal(out[i % cfg.num_clients, 0].numpy(), refs[i])
        with torch.no_grad():
            lg, _ = seq._prefill(params, {"tokens": torch.as_tensor(toks, dtype=torch.int64)})
        _close(lg, ref_logits[i], tol=1e-4)


def check_decode_freezes_other_rows(arch):
    """Two requests, one per client, decoded together for several steps,
    then one more request decoded alone while the first two slots sit
    finished: each slot's SSM and conv caches equal those of the request
    served alone by the sequential engine."""
    cfg, model, params = _port(arch)
    M = cfg.num_clients
    prompts = _prompts(cfg)[:3]
    new = [5, 7, 4]
    eng = ContinuousEngine(model, params, M, MAX_LEN, slots=3, chunk=16,
                           device="cpu")
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(Request(id=i, client=i % M, tokens=p, new_tokens=n))
    res = eng.run()
    seq = ServeEngine(model, params, M, MAX_LEN, device="cpu")
    for i, (p, n) in enumerate(zip(prompts, new)):
        m = i % M
        toks = torch.as_tensor(_one_row(cfg, i, p), dtype=torch.int64)
        with torch.no_grad():
            _, caches = seq._prefill(params, {"tokens": toks})
            for t in range(n - 1):
                tok = torch.zeros((M, 1, 1), dtype=torch.int64)
                tok[m, 0, 0] = int(res[i][t])
                seq._decode(params, caches, tok, len(p) + t)
        # request i sat in slot i (three free slots, admitted in order)
        for side, pool, ref, row in (
                ("tower", eng._tcache, caches.tower[m], 0),
                ("server", eng._scache, caches.server, m)):
            got = dict(tree_leaves_with_path(pool))
            want = dict(tree_leaves_with_path(ref))
            keys = [k for k in want
                    if k.endswith(("conv_x", "conv_B", "conv_C", "state"))]
            assert keys, side
            for k in keys:
                _close(got[k][i], want[k][row].numpy())
