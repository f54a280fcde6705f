"""The port's paper classifiers against the JAX reference's, on weights
initialised in JAX and carried across with `params_from_jax`, and inputs
drawn with numpy. The towers run mapped over the client axis (jax.vmap /
torch.func.vmap), the server on the folded smashed batch. Outputs (smashed
activations and logits) agree within 1e-5 and the gradients of a fixed
random projection of the logits within 1e-4, for the smoke configs and for
full-width paper-resnet16 (M = 10, b = 2). f32 throughout.

XLA's `SAME` padding is pinned on its own: a 3x3 stride-2 conv pads 0
before and 1 after an even size (16 -> 8, 32 -> 16), where PyTorch's
`padding=1` would shift every window by a pixel.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.split import stack_towers as jax_stack_towers
from repro.models import classifiers as jax_classifiers
from repro.models.registry import build_model as jax_build_model
from repro.utils.sharding import strip
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.models import classifiers
from repro_torch.models.registry import build_model
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

CASES = {  # name: (arch, smoke, batch per client)
    "mlp-smoke": ("paper-mlp", True, 3),
    "resnet-smoke": ("paper-resnet16", True, 3),
    "mlp-full": ("paper-mlp", False, 2),
    "resnet-full": ("paper-resnet16", False, 2),
}


@functools.lru_cache(maxsize=None)
def _reference(name):
    arch, smoke, b = CASES[name]
    cfg = jax_get_config(arch, smoke=smoke)
    model = jax_build_model(cfg)
    M = cfg.num_clients

    @jax.jit
    def init(rng):
        return strip({"towers": jax_stack_towers(model.init_tower, rng, M),
                      "server": model.init_server(jax.random.fold_in(rng, 1))})

    params = init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    shape = (M, b, cfg.image_size, cfg.image_size) + (
        (cfg.image_channels,) if cfg.image_channels > 1 else ())
    image = rng.normal(size=shape).astype(np.float32)
    proj = rng.normal(size=(M * b, cfg.num_classes)).astype(np.float32)

    def forward(params):
        h = jax.vmap(model.tower_forward)(params["towers"], {"image": image})["h"]
        logits, _ = model.server_forward(
            params["server"], {"h": h.reshape((-1,) + h.shape[2:])})
        return h, logits

    def objective(params):
        return jnp.sum(forward(params)[1] * proj)

    h, logits = jax.jit(forward)(params)
    grads = jax.jit(jax.grad(objective))(params)
    return cfg, params, image, proj, np.asarray(h), np.asarray(logits), grads


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_grads_match_jax(name):
    cfg_j, params_j, image, proj, h_j, logits_j, grads_j = _reference(name)
    arch, smoke, _ = CASES[name]
    cfg = get_config(arch, smoke=smoke)
    assert cfg.__dict__ == cfg_j.__dict__
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, params_j), "cpu", cfg)
    for x in tree_leaves(params):
        x.requires_grad_()
    h = torch.func.vmap(model.tower_forward)(params["towers"],
                                             {"image": torch.from_numpy(image)})["h"]
    logits, aux = model.server_forward(params["server"],
                                       {"h": h.reshape((-1,) + tuple(h.shape[2:]))})
    assert float(aux) == 0.0
    np.testing.assert_allclose(h.detach().numpy(), h_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), logits_j, rtol=1e-5, atol=1e-5)
    leaves = tree_leaves_with_path(params)
    grads = torch.autograd.grad((logits * torch.from_numpy(proj)).sum(),
                                [x for _, x in leaves])
    ref = flatten_dict(grads_j)
    assert sorted(p for p, _ in leaves) == sorted(ref)
    for (path, _), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[path]), rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_full_resnet_split_shapes():
    """Full paper-resnet16: 10 tower leaves (9 convs + 1 projection) and 7
    on the server; the tower's stride-2 stage takes 32 x 32 to 16 x 16."""
    *_, h_j, logits_j, _ = _reference("resnet-full")
    model = build_model(get_config("paper-resnet16"))
    assert h_j.shape == (10, 2, 16, 16, 32) and logits_j.shape == (20, 10)
    gen = torch.Generator().manual_seed(0)
    assert len(tree_leaves(model.init_tower(gen))) == 10
    assert len(tree_leaves(model.init_server(gen))) == 7


@pytest.mark.parametrize("n,stride,k", [(16, 2, 3), (32, 2, 3), (15, 2, 3),
                                        (16, 1, 3), (32, 2, 1)])
def test_same_padding_matches_xla(n, stride, k):
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(2, n, n, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 5)).astype(np.float32)
    ref = jax_classifiers._conv_apply({"w": jnp.asarray(w)}, jnp.asarray(x), stride)
    out = classifiers._conv_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride)
    assert out.shape == ref.shape == (2, -(-n // stride), -(-n // stride), 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if (n, stride, k) in ((16, 2, 3), (32, 2, 3)):
        assert classifiers.same_padding(n, k, stride) == (0, 1)
