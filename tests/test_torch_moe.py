"""The port's MoE layer (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`) on the same numpy parameters and inputs, in f32.

Cases: global dispatch and grouped dispatch (`moe_groups`), shared experts
on and off, and the default capacity factor 1.25 with a sharpened router,
where experts overflow and tokens are dropped (the port's dispatch tally
must count drops there, and none under the smoke configs' factor 8).
Output and aux within 1e-5; the gradients of a weighted sum of the output
plus the aux loss, with respect to every parameter and the input, within
1e-4 (the reference's kernel-test tolerances). The router's top-k must
pick the reference's experts in the reference's order on a tie-free router.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.moe import moe_forward as jax_moe_forward
from repro_torch.configs import get_config
from repro_torch.models import moe as moe_mod
from repro_torch.utils.tree import tree_map

TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 24
CASES = {  # name: (config updates, router scale, tokens dropped)
    "global-shared": ({}, 1.0, False),
    "global-no-shared": ({"num_shared_experts": 0}, 1.0, False),
    "grouped-shared": ({"moe_groups": 4}, 1.0, False),
    "dropping": ({"capacity_factor": 1.25, "num_experts": 8,
                  "experts_per_token": 2}, 4.0, True),
    "dropping-grouped": ({"capacity_factor": 1.25, "num_experts": 8,
                          "moe_groups": 2}, 4.0, True),
}


def _cfgs(name):
    kw = CASES[name][0]
    base = dict(dtype="float32")
    return (get_config("deepseek-moe-16b", smoke=True).with_updates(**base, **kw),
            jax_get_config("deepseek-moe-16b", smoke=True).with_updates(**base, **kw))


def _params(cfg, router_scale, seed=0):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    p = {"router": router_scale * w(d, E, fan_in=d), "wg": w(E, d, f, fan_in=d),
         "wu": w(E, d, f, fan_in=d), "wd": w(E, f, d, fan_in=f),
         "norm": {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"wg": w(d, fs, fan_in=d), "wu": w(d, fs, fan_in=d),
                       "wd": w(fs, d, fan_in=fs)}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    g = rng.standard_normal((B, S, d)).astype(np.float32)
    return p, x, g


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's (y, aux, grads wrt (params, x)) of case `name`."""
    cfg, cfg_j = _cfgs(name)
    p, x, g = _params(cfg, CASES[name][1])

    def objective(p, x):
        y, aux = jax_moe_forward(p, x, cfg_j)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(objective, argnums=(0, 1),
                                                      has_aux=True))(p, x)
    return jax.tree.map(np.asarray, (y, aux, grads))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_matches_jax(name):
    cfg, _ = _cfgs(name)
    p, x, g = _params(cfg, CASES[name][1])
    y_j, aux_j, (gp_j, gx_j) = _reference(name)
    pt = tree_map(lambda a: torch.tensor(a, requires_grad=True), p)
    xt = torch.tensor(x, requires_grad=True)
    moe_mod.moe_forward.tally = tally = torch.zeros(2, dtype=torch.int64)
    try:
        y, aux = moe_mod.moe_forward(pt, xt, cfg)
    finally:
        moe_mod.moe_forward.tally = None
    assert int(tally[1]) == B * S * cfg.experts_per_token  # rows routed
    assert (int(tally[0]) < int(tally[1])) == CASES[name][2], tally  # rows kept
    np.testing.assert_allclose(y.detach().numpy(), y_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=TOL, atol=TOL)
    ((y * torch.tensor(g)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, rtol=GRAD_TOL, atol=GRAD_TOL)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(gp_j)[0])
    for path, gj in flat_j.items():
        node = pt
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.grad.numpy(), gj, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(path))


def test_capacity_rounds_up_to_eight():
    from repro.models.moe import _capacity as jax_capacity

    for T, E, k, f in ((48, 4, 2, 1.25), (4096, 64, 6, 1.25), (3, 128, 8, 8.0),
                       (1000, 8, 2, 1.0)):
        assert moe_mod._capacity(T, E, k, f) == jax_capacity(T, E, k, f)
        assert moe_mod._capacity(T, E, k, f) % 8 == 0


def test_topk_order_matches_jax_on_a_tie_free_router():
    rng = np.random.default_rng(5)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((64, 16)), jnp.float32), -1)
    vals_j, idx_j = jax.lax.top_k(probs, 6)
    vals, idx = torch.topk(torch.tensor(np.asarray(probs)), 6, dim=-1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))
