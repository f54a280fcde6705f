"""The LM training forward of the PyTorch port against the JAX reference,
on the smoke configs of zamba2-7b (hybrid), mamba2-130m (ssm) and
gemma3-12b (dense, its `swa` and `full` kinds), in f32: the same numpy
inputs and the same weights (initialised in JAX, carried across with the
port's converter) through `repro.models` and `repro_torch.models`.

Covered: `attn_forward` (causal, with and without a window),
`_causal_conv`, `_gated_norm`, `mamba_forward` with L not a multiple of
the chunk, the `shared_attn` block, and the whole split model (tower and
server `Stack.forward`) under `scan_layers` off and on and `remat` none
and block. Tolerances: outputs within 1e-5 (f32, reduction order and
transcendental ulps); gradients within 1e-4 of each leaf's largest
gradient (the split model's gradients reach 1e3, summed over thousands of
terms).

The reference's side of every case (its params, inputs, outputs and
gradients, as numpy) is one `functools.lru_cache`d function per case
kind; the module's `references` fixture fills every entry at once in
threads, so XLA compiles the cases' programs in parallel, and each test
reads its entry.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.split import stack_towers as jax_stack_towers
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import stacks as JST
from repro.models.registry import build_model as jax_build_model
from repro.utils.sharding import strip
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.core.split import client_view
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import stacks as TST
from repro_torch.models.registry import build_model
from repro_torch.utils.convert import convert_tree, params_from_jax
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

TOL, GTOL = 1e-5, 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _grad_close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= GTOL * scale, (err, scale)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _cfgs(arch, **kw):
    return (jax_get_config(arch, smoke=True).with_updates(**kw),
            get_config(arch, smoke=True).with_updates(**kw))


def _port(tree_j, cfg):
    return tree_map(lambda x: x.requires_grad_(),
                    convert_tree(jax.tree.map(np.asarray, tree_j), "cpu", cfg))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_case(fn_j, pj, x, g):
    """The reference's side of a layer case, as numpy: (params, x, g, f(p,
    x), the gradients of sum(f(p, x) * g) with respect to the params and
    x)."""
    def loss(p, x):
        out = fn_j(p, x)
        return jnp.sum(out * g), out

    (_, out), want = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        pj, jnp.asarray(x))
    return _numpy(pj), x, g, np.asarray(out), _numpy(want)


def _grads_match(want, fn_t, pt, x, g):
    """Gradients of sum(f(p, x) * g) with respect to the params and x."""
    xt = torch.tensor(x, requires_grad=True)
    (fn_t(pt, xt) * torch.tensor(g)).sum().backward()
    _grad_close(xt.grad, want[1])
    flat = flatten_dict(want[0])
    for path, leaf in tree_leaves_with_path(pt):
        _grad_close(leaf.grad, flat[path])


ATTN_CASES = [("gemma3-12b", 0), ("gemma3-12b", 16), ("zamba2-7b", 0)]


@functools.lru_cache(maxsize=None)
def _attn_reference(arch, window):
    cfg_j, cfg = _cfgs(arch)
    pj = strip(JL.attn_params(jax.random.PRNGKey(3), cfg_j))
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 37, cfg.d_model)
    g = _rand(rng, 2, 37, cfg.d_model)
    fn_j = jax.jit(functools.partial(JL.attn_forward, cfg=cfg_j, window=window))
    return _reference_case(fn_j, pj, x, g)


@pytest.mark.parametrize("arch,window", ATTN_CASES)
def test_attn_forward(arch, window, references):
    _, cfg = _cfgs(arch)
    pj, x, g, out_j, want = _attn_reference(arch, window)
    pt = _port(pj, cfg)
    _close(TL.attn_forward(pt, torch.tensor(x), cfg, window=window), out_j)
    _grads_match(want, lambda p, x: TL.attn_forward(p, x, cfg, window=window),
                 pt, x, g)


def test_causal_conv_and_gated_norm():
    rng = np.random.default_rng(2)
    x, w = _rand(rng, 2, 13, 24), _rand(rng, 4, 24)
    _close(TS._causal_conv(torch.tensor(x), torch.tensor(w)),
           jax.jit(JS._causal_conv)(jnp.asarray(x), jnp.asarray(w)))
    y, z, s = _rand(rng, 2, 13, 24), _rand(rng, 2, 13, 24), _rand(rng, 24)
    _close(TS._gated_norm({"scale": torch.tensor(s)}, torch.tensor(y), torch.tensor(z), 1e-6),
           jax.jit(JS._gated_norm, static_argnums=3)(
               {"scale": jnp.asarray(s)}, jnp.asarray(y), jnp.asarray(z), 1e-6))
    a = np.array([-30.0, -1.0, 0.0, 2.0, 19.0, 25.0, 80.0], np.float32)
    _close(TS.softplus(torch.tensor(a)), jax.nn.softplus(jnp.asarray(a)))


MAMBA_CASES = [("mamba2-130m", 37), ("zamba2-7b", 32), ("zamba2-7b", 21)]


@functools.lru_cache(maxsize=None)
def _mamba_reference(arch, L):
    cfg_j, cfg = _cfgs(arch)
    pj = strip(JS.mamba_params(jax.random.PRNGKey(4), cfg_j))
    # nonzero A_log / dt_bias / D so that every leaf is exercised
    rng = np.random.default_rng(5)
    H = pj["A_log"].shape[0]
    pj = dict(pj, A_log=jnp.asarray(_rand(rng, H)) * 0.5,
              dt_bias=jnp.asarray(_rand(rng, H)) * 0.5,
              D=1.0 + 0.1 * jnp.asarray(_rand(rng, H)))
    x = _rand(rng, 2, L, cfg.d_model)
    g = _rand(rng, 2, L, cfg.d_model)
    fn_j = jax.jit(functools.partial(JS.mamba_forward, cfg=cfg_j))
    return _reference_case(fn_j, pj, x, g)


@pytest.mark.parametrize("arch,L", MAMBA_CASES)
def test_mamba_forward(arch, L, references):
    """L = 37 and 21 are not multiples of the smoke chunk (16): the pad-to-
    chunk step runs."""
    _, cfg = _cfgs(arch)
    pj, x, g, out_j, want = _mamba_reference(arch, L)
    pt = _port(pj, cfg)
    for k in ("A_log", "D", "dt_bias"):
        assert pt[k].dtype == torch.float32
    _close(TS.mamba_forward(pt, torch.tensor(x), cfg), out_j)
    _grads_match(want, lambda p, x: TS.mamba_forward(p, x, cfg), pt, x, g)


@functools.lru_cache(maxsize=None)
def _shared_attn_reference():
    cfg_j, cfg = _cfgs("zamba2-7b")
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(6), 3)
    shared_j = strip({"attn": JL.attn_params(k1, cfg_j), "mlp": JL.mlp_params(k2, cfg_j)})
    blk_j = JST.make_block(cfg_j, "shared_attn")
    pj = strip(blk_j.init(k3))
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 19, cfg.d_model)
    g = _rand(rng, 2, 19, cfg.d_model)

    def fn_j(p, x):
        return blk_j.forward(p["layer"], x, {"shared": p["shared"]})[0]

    return _reference_case(jax.jit(fn_j), {"layer": pj, "shared": shared_j}, x, g)


def test_shared_attn_block(references):
    """The zamba2 layer: the stack-level shared attention+MLP block from
    ctx["shared"], then the layer's own mamba."""
    _, cfg = _cfgs("zamba2-7b")
    both_j, x, g, out_j, want = _shared_attn_reference()
    both_t = {"layer": _port(both_j["layer"], cfg), "shared": _port(both_j["shared"], cfg)}

    def fn_t(p, x):
        return TST.make_block(cfg, "shared_attn").forward(
            p["layer"], x, {"shared": p["shared"]})[0]

    _close(fn_t(both_t, torch.tensor(x)), out_j)
    _grads_match(want, fn_t, both_t, x, g)


VARIANTS = {  # (arch, config updates)
    "zamba2-smoke": ("zamba2-7b", {}),
    # kinds m,sa,m,sa,m,sa,m: server (sa, m) x 3
    "zamba2-scan-block": ("zamba2-7b", {"num_layers": 7, "scan_layers": True,
                                        "remat": "block"}),
    "zamba2-noscan-block": ("zamba2-7b", {"num_layers": 5, "remat": "block"}),
    "mamba2-smoke": ("mamba2-130m", {}),
    "mamba2-scan-block": ("mamba2-130m", {"num_layers": 4, "scan_layers": True,
                                          "remat": "block"}),
    "gemma3-smoke": ("gemma3-12b", {}),
    "gemma3-scan-block": ("gemma3-12b", {"num_layers": 6, "split_layers": 2,
                                         "scan_layers": True, "remat": "block"}),
}


@functools.lru_cache(maxsize=None)
def _split_reference(variant):
    """The reference's split model of `variant`: (params, tokens, g,
    logits, gradients of sum(logits * g)), as numpy."""
    arch, kw = VARIANTS[variant]
    cfg_j, cfg = _cfgs(arch, **kw)
    model_j = jax_build_model(cfg_j)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 21))
    g = _rand(rng, 2, 21, cfg.vocab_size)

    def loss_j(p):
        tower = jax.tree.map(lambda x: x[0], p["towers"])
        h = model_j.tower_forward(tower, {"tokens": jnp.asarray(toks)})
        logits, _ = model_j.server_forward(p["server"], h)
        return jnp.sum(logits * g), logits

    @jax.jit
    def init_and_grads(r):
        # one program: the init, then the logits and gradients at it
        p = strip({"towers": jax_stack_towers(model_j.init_tower, r, 1),
                   "server": model_j.init_server(jax.random.fold_in(r, 1))})
        (_, logits), grads = jax.value_and_grad(loss_j, has_aux=True)(p)
        return p, logits, grads

    params_j, logits_j, grads_j = init_and_grads(jax.random.PRNGKey(8))
    return _numpy(params_j), toks, g, np.asarray(logits_j), _numpy(grads_j)


@pytest.fixture(scope="module")
def references():
    """Every case's reference side, computed once, in threads."""
    jobs = ([functools.partial(_attn_reference, *c) for c in ATTN_CASES]
            + [functools.partial(_mamba_reference, *c) for c in MAMBA_CASES]
            + [_shared_attn_reference]
            + [functools.partial(_split_reference, v) for v in VARIANTS])
    with ThreadPoolExecutor(len(jobs)) as ex:
        for fut in [ex.submit(job) for job in jobs]:
            fut.result()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_model_forward_and_gradients(variant, references):
    """tower_forward then server_forward of the split model (one client's
    tower), logits and the gradients of sum(logits * g) with respect to
    every parameter of the tower and the server."""
    arch, kw = VARIANTS[variant]
    _, cfg = _cfgs(arch, **kw)
    model = build_model(cfg)
    params_j, toks, g, logits_j, grads_j = _split_reference(variant)
    params = tree_map(lambda x: x.requires_grad_(), params_from_jax(params_j, "cpu", cfg))
    if kw.get("scan_layers"):
        assert any(isinstance(v, list) for v in params["server"]["blocks"].values())
    h = model.tower_forward(client_view(params["towers"], 0),
                            {"tokens": torch.tensor(toks)})
    logits, aux = model.server_forward(params["server"], h)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, logits_j)
    (logits * torch.tensor(g)).sum().backward()
    want = params_from_jax(grads_j, "cpu", cfg)
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        _grad_close(a.grad, b.numpy())


def test_training_and_serving_trees():
    """The training tree holds every leaf in param_dtype (f32 masters; the
    Mamba leaves A_log, D and dt_bias always f32); the serving tree holds
    matmul weights in cfg.dtype, as slice 1's engines allocate them."""
    cfg = get_config("gemma3-12b", smoke=True).with_updates(dtype="bfloat16")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    train = model.init_server(gen)
    serve = model.init_server(gen, serving=True)
    assert {x.dtype for x in tree_leaves(train)} == {torch.float32}
    blk = serve["blocks"]["seg0"]["0"]
    assert blk["attn"]["wq"].dtype == serve["head"]["w"].dtype == torch.bfloat16
    assert blk["attn"]["norm"]["scale"].dtype == torch.float32
    zcfg = get_config("zamba2-7b", smoke=True).with_updates(dtype="bfloat16")
    ztree = build_model(zcfg).init_server(gen)
    assert "shared" in ztree["blocks"]
    assert {x.dtype for x in tree_leaves(ztree)} == {torch.float32}


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_serving_of_ssm_and_hybrid_refused(arch):
    """The Mamba serving paths are ported (tests/test_torch_ssm_serving.py,
    tests/test_torch_hybrid_serving.py): the caches are the reference's
    (raw conv tails [B, W-1, D] in cfg.dtype, the SSM state [B, H, P, N] in
    f32). What stays refused for these families is a ring KV cache
    (decode_long_window), which the continuous engine does not take."""
    from repro_torch.launch.serve import init_params
    from repro_torch.serve.continuous import ContinuousEngine

    cfg = get_config(arch, smoke=True)
    leaves = dict(tree_leaves_with_path(build_model(cfg).init_tower_cache(3, 8, "cpu")))
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    states = [v for k, v in leaves.items() if k.endswith("state")]
    tails = [v for k, v in leaves.items() if k.endswith("conv_x")]
    assert states and len(tails) == len(states)
    assert all(s.shape == (3, H, cfg.ssm_headdim, cfg.ssm_state)
               and s.dtype == torch.float32 for s in states)
    assert all(t.shape == (3, cfg.ssm_conv_width - 1, d_in) for t in tails)
    ring = build_model(cfg.with_updates(decode_long_window=8))
    params = init_params(ring, cfg.num_clients, 0, "cpu")
    with pytest.raises(ValueError, match="ring KV caches"):
        ContinuousEngine(ring, params, cfg.num_clients, 16, device="cpu")
