"""The port's MoE serving path on deepseek-moe-16b's smoke config (a dense
lead layer, shared experts) against the JAX reference, in f32; the block
and engine checks live in tests/torch_moe_serving.py (prefill + decode
against the forward: tests/test_torch_decode_consistency.py):

  * the `moe` block's prefill, decode and extend within 1e-5 of the
    reference's;
  * greedy tokens of the port's two engines equal the reference's
    sequential and continuous engines' on the reference's scenario;
  * slot-alone dispatch: 16 slots decode one token each through a tower
    that holds an MoE layer (8 experts, capacity factor 1.25), every slot
    with the same prompt and token, so the router sends all 16 tokens to
    the same experts. Dispatched together, each of those experts would
    keep 8 of its 16 rows; the port's tower decode with `rows_alone` (as
    the continuous engine calls it) dispatches each slot alone and equals
    the reference's batch-1 tower decode vmapped over the slots within
    1e-5, while the batched dispatch does not;
  * the serving tree of the full config (on the meta device) stores the
    expert stacks and shared experts in bf16 and the router in f32, so
    deepseek-moe-16b's two towers and server fit one card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_moe_serving as MS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.split import client_view
from repro_torch.launch.serve import init_params
from repro_torch.models import build_model
from repro_torch.models import moe as TM
from repro_torch.nn.init import abstract_params
from repro_torch.utils.convert import params_to_reference

ARCH = "deepseek-moe-16b"


def test_moe_block_serving_matches_reference():
    MS.check_block_serving(ARCH)


def test_greedy_parity_with_reference():
    MS.check_greedy_parity(ARCH)


SLOTS = 16
ALONE = dict(num_layers=3, split_layers=2, num_experts=8, capacity_factor=1.25)


@functools.lru_cache(maxsize=None)
def _alone_setup():
    """deepseek-moe-16b's smoke config with its tower holding the dense
    lead and one MoE layer; 16 slots that prefilled the same prompt."""
    cfg = get_config(ARCH, smoke=True).with_updates(**ALONE)
    cfg_j = jax_get_config(ARCH, smoke=True).with_updates(**ALONE)
    model = build_model(cfg)
    params = init_params(model, 1, 9, "cpu")
    tp = client_view(params["towers"], 0)
    L, cap = 6, 12
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(1, L))
    with torch.no_grad():
        _, cache = model.tower_prefill(tp, {"tokens": torch.as_tensor(prompt)}, cap)
    return cfg, cfg_j, model, params, tp, cache, L


def test_tower_decode_dispatches_each_slot_alone():
    cfg, cfg_j, model, params, tp, cache1, L = _alone_setup()
    tok = np.full((SLOTS, 1), 7, np.int64)
    pos = np.full((SLOTS,), L, np.int32)

    # the reference: batch-1 tower decode under vmap over the slots
    tree = jax.tree.map(jnp.asarray, params_to_reference(params, cfg))
    tp_j = jax.tree.map(lambda x: x[0], tree["towers"])
    model_j = jax_build_model(cfg_j)
    c1 = jax.tree.map(lambda x: jnp.asarray(x.numpy())[None], cache1)
    caches = jax.tree.map(lambda x: jnp.repeat(x, SLOTS, axis=0), c1)
    want = jax.jit(jax.vmap(
        lambda inp, tc, p: model_j.tower_decode(tp_j, inp, tc, p)[0]["h"]))(
        {"tokens": jnp.asarray(tok)[:, None]}, caches, jnp.asarray(pos))
    want = np.asarray(want)[:, 0]  # [SLOTS, 1, d]

    def port(rows_alone):
        cache = jax.tree.map(lambda x: x.expand(SLOTS, *x.shape[1:]).clone(), cache1)
        TM.moe_forward.tally = torch.zeros(2, dtype=torch.int64)
        try:
            with torch.no_grad():
                h = model.tower_decode(tp, {"tokens": torch.as_tensor(tok)}, cache,
                                       torch.as_tensor(pos), rows_alone=rows_alone)["h"]
            kept, routed = TM.moe_forward.tally.tolist()
        finally:
            TM.moe_forward.tally = None
        return h, routed - kept

    h, dropped = port(True)
    assert dropped == 0
    MS._close(h, want)
    h_batched, dropped = port(False)
    assert dropped > 0  # 16 rows reach each chosen expert; it keeps 8
    assert not np.allclose(h_batched.numpy(), want, atol=1e-3)


def test_serving_tree_stores_experts_in_the_compute_dtype():
    from repro_torch.utils.tree import tree_leaves_with_path

    model = build_model(get_config(ARCH))
    gen = torch.Generator()
    with abstract_params():
        trees = {"serving": model.init_server(gen, serving=True),
                 "training": model.init_server(gen)}
    for name, tree in trees.items():
        leaves = {k: x.dtype for k, x in tree_leaves_with_path(tree) if "/moe/" in k}
        experts = {k: dt for k, dt in leaves.items()
                   if k.endswith(("/wg", "/wu", "/wd"))}
        assert len(experts) == 26 * 6  # routed and shared, in every MoE layer
        want = torch.bfloat16 if name == "serving" else torch.float32
        assert set(experts.values()) == {want}
        assert {dt for k, dt in leaves.items() if k.endswith("/router")} == {torch.float32}
