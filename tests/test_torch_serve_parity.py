"""The PyTorch port's serving slice against the JAX reference.

Two configs: the gemma3-12b smoke config, and a 6-layer `scan_layers=True`
variant whose server holds a stacked (repeated) segment, so the weight
converter's unstacking is exercised. Weights are initialised in JAX and
carried across with `params_from_jax`; prompts come from numpy.

The scenario is the reference's own (tests/test_serve_continuous.py): 3
slots serving 5 mixed-length requests with chunk 4 (slot eviction and
reuse, multi-chunk prefill interleaved with live decode). Greedy output of
the port's ContinuousEngine and of its generate_sequential must equal the
reference's generate_sequential token for token, with the reference's
Pallas decode kernel on (interpret mode) and off. Prefill logits agree
within 1e-4 (f32, reduction order). Temperature sampling is checked for
reproducibility inside the port only: jax.random cannot be reproduced.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.split import stack_towers as jax_stack_towers
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils.convert import params_from_jax

PROMPT_LENS = [3, 7, 10, 5, 4]
NEW_TOKENS = [6, 4, 5, 3, 7]
MAX_LEN = 20
VARIANTS = {
    "smoke": {},
    # kinds swa,full | full,swa,full,swa -> server seg0 = (full, swa) x 2
    "scan6": {"num_layers": 6, "split_layers": 2, "scan_layers": True},
}


@functools.lru_cache(maxsize=None)
def _reference(variant):
    cfg = jax_get_config("gemma3-12b", smoke=True).with_updates(**VARIANTS[variant])
    model = jax_build_model(cfg)

    @jax.jit  # one compile instead of one per eager op
    def init(rng):
        return strip({
            "towers": jax_stack_towers(model.init_tower, rng, cfg.num_clients),
            "server": model.init_server(jax.random.fold_in(rng, 1)),
        })

    return cfg, model, init(jax.random.PRNGKey(7))


@functools.lru_cache(maxsize=None)
def _port(variant):
    cfg_j, _, params_j = _reference(variant)
    cfg = get_config("gemma3-12b", smoke=True).with_updates(**VARIANTS[variant])
    assert cfg.__dict__ == cfg_j.__dict__
    params = params_from_jax(jax.tree.map(np.asarray, params_j), "cpu", cfg)
    return cfg, build_model(cfg), params


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
def _reference_outputs(variant):
    """{use_flash_kernel: per-request greedy tokens} from the reference's
    generate_sequential. The flag only switches decode attention, so the
    second engine reuses the first one's compiled prefill."""
    cfg, _, params = _reference(variant)
    outs, prefill = {}, None
    for flash in (False, True):
        cfg_f = cfg.with_updates(use_flash_kernel=flash)
        eng = JaxServeEngine(jax_build_model(cfg_f), params, cfg.num_clients,
                             MAX_LEN)
        if prefill is not None:
            eng._prefill = prefill
        prefill = eng._prefill
        outs[flash] = [
            np.asarray(eng.generate_sequential(
                {"tokens": jnp.asarray(_one_row(cfg, i, p))}, new_tokens=n)
            )[i % cfg.num_clients, 0]
            for i, (p, n) in enumerate(zip(_prompts(cfg), NEW_TOKENS))]
    return outs


def test_converted_tree_unstacks_segments():
    cfg, _, params = _port("scan6")
    seg = params["server"]["blocks"]["seg0"]
    assert isinstance(seg, list) and len(seg) == 2 and set(seg[0]) == {"0", "1"}
    assert seg[0]["0"]["attn"]["wq"].shape == (cfg.d_model, cfg.num_heads,
                                                cfg.head_dim)
    assert params["towers"]["embed"]["table"].shape[0] == cfg.num_clients
    _, _, pj = _reference("scan6")
    np.testing.assert_array_equal(
        seg[1]["1"]["mlp"]["wd"].numpy(),
        np.asarray(pj["server"]["blocks"]["seg0"]["1"]["mlp"]["wd"][1]))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_parity_with_reference(variant, flash):
    cfg, model, params = _port(variant)
    refs = _reference_outputs(variant)[flash]
    prompts = _prompts(cfg)

    eng = ContinuousEngine(model, params, cfg.num_clients, MAX_LEN, slots=3,
                           chunk=4, device="cpu")
    for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        eng.submit(Request(id=i, client=i % cfg.num_clients, tokens=p,
                           new_tokens=n))
    res = eng.run()
    assert eng.stats["admitted"] == len(prompts)
    assert eng.logits_finite()

    seq = ServeEngine(model, params, cfg.num_clients, MAX_LEN, device="cpu")
    for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        np.testing.assert_array_equal(res[i], refs[i])
        out = seq.generate_sequential({"tokens": _one_row(cfg, i, p)}, n)
        np.testing.assert_array_equal(out[i % cfg.num_clients, 0].numpy(),
                                      refs[i])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_logits_match_reference(variant):
    cfg_j, model_j, params_j = _reference(variant)
    cfg, model, params = _port(variant)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(cfg.num_clients, 2, 9))
    want, _ = JaxServeEngine(model_j, params_j, cfg.num_clients,
                             MAX_LEN)._prefill(params_j,
                                               {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = ServeEngine(model, params, cfg.num_clients, MAX_LEN,
                             device="cpu")._prefill(params, {"tokens": torch.tensor(toks)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_temperature_sampling_reproducible():
    """Sampling keys depend on (seed, request id, position) only: the same
    seed gives the same tokens under a different slot count (another
    schedule and slot assignment); another seed diverges."""
    cfg, model, params = _port("smoke")
    prompts = _prompts(cfg)[:3]

    def run_with(seed, slots):
        eng = ContinuousEngine(model, params, cfg.num_clients, MAX_LEN,
                               slots=slots, chunk=4, seed=seed, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(id=i, client=i % cfg.num_clients, tokens=p,
                               new_tokens=6, temperature=0.9))
        return eng.run()

    a, b, c = run_with(123, 2), run_with(123, 3), run_with(321, 2)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(a[i], b[i])
    assert any(not np.array_equal(a[i], c[i]) for i in range(len(prompts)))

    seq = ServeEngine(model, params, cfg.num_clients, MAX_LEN, device="cpu")
    toks = np.stack([p[:3] for p in prompts[:2]]).reshape(cfg.num_clients, 1, 3)
    s1 = seq.generate({"tokens": toks}, 6, temperature=0.9, rng=5)
    s2 = seq.generate({"tokens": toks}, 6, temperature=0.9, rng=5)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
