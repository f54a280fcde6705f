"""Non-causal self-attention and cross attention through the port against
the JAX reference, in f32 on the CPU.

  * K2's wrapper on CPU tensors (`flash_attention(..., causal=False)`, its
    plain version `mha_reference`) against the reference's
    `mha_reference`, for non-causal self-attention (Sq == Sk) and cross
    attention with Sq != Sk and GQA; and its gradients (the wrapper's
    backward recomputes through the plain version);
  * `attn_forward` with `causal=False` and with `kv_src` (no mask, no
    rope on the keys; Sk != Sq and Sk == Sq) against the reference's
    `attn_forward`, forward and gradients (attn_impl="chunked" is
    tests/test_torch_chunked_attention.py's);
  * the wrapper's refusal of a causal cross call;
  * the `bidir` and `cross` blocks of the stacks (and which serving
    functions each has).

Tolerances: 2e-5 on outputs (tests/test_kernels.py's f32 limit), 1e-4 on
gradients of max(1, |g|) scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ref import mha_reference as jax_mha
from repro.models import layers as JL
from repro.models import stacks as JST
from repro.utils.sharding import strip
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as TL
from repro_torch.models import stacks as TST
from repro_torch.utils.convert import convert_tree
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

TOL, GTOL = 2e-5, 1e-4
CASES = [
    # (B, Sq, Sk, Hq, Hkv, D): Sq == Sk is non-causal self-attention
    (2, 40, 40, 4, 4, 32),
    (1, 30, 30, 4, 2, 64),
    (2, 24, 17, 4, 2, 32),   # the VLM smoke's cross attention
    (1, 33, 70, 8, 2, 16),
]


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _qkv(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D = case
    rng = np.random.default_rng(seed)
    return _rand(rng, B, Sq, Hq, D), _rand(rng, B, Sk, Hkv, D), _rand(rng, B, Sk, Hkv, D)


def _grad_close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= GTOL * scale, (err, scale)


@jax.jit
def _jax_noncausal(q, k, v, g):
    """The reference's mha_reference without the causal mask, and the
    gradients of sum(mha_reference * g)."""
    grads = jax.grad(lambda q, k, v: jnp.sum(jax_mha(q, k, v, causal=False) * g),
                     argnums=(0, 1, 2))(q, k, v)
    return jax_mha(q, k, v, causal=False), grads


@pytest.mark.parametrize("case", CASES)
def test_wrapper_without_causal_mask_matches_jax(case):
    arrs = _qkv(case)
    t = [torch.tensor(a, requires_grad=True) for a in arrs]
    ja = list(map(jnp.asarray, arrs))
    out = flash_attention(*t, causal=False, cross=case[1] != case[2])
    g = np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    want, want_g = _jax_noncausal(*ja, g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    (out * torch.tensor(g)).sum().backward()
    for a, w in zip(t, want_g):
        _grad_close(a.grad, w)


def test_wrapper_refuses_a_causal_cross_call():
    q, k, v = map(torch.tensor, _qkv(CASES[2]))
    with pytest.raises(ValueError, match="cross attention takes no causal mask"):
        flash_attention(q, k, v, causal=True, cross=True)


def _port(tree_j, cfg):
    return tree_map(lambda x: x.requires_grad_(),
                    convert_tree(jax.tree.map(np.asarray, tree_j), "cpu", cfg))


def _check(fn_j, pj, fn_t, pt, inputs, g):
    """fn(p, *inputs) forward within TOL and the gradients of
    sum(fn * g) with respect to the params and every input within GTOL."""
    ja = [jnp.asarray(a) for a in inputs]
    want, vjp = jax.vjp(fn_j, pj, *ja)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn_t(pt, *ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    grads = vjp(jnp.asarray(g))
    (out * torch.tensor(g)).sum().backward()
    for t, w in zip(ts, grads[1:]):
        _grad_close(t.grad, w)
    flat = flatten_dict(grads[0])
    for path, leaf in tree_leaves_with_path(pt):
        _grad_close(leaf.grad, flat[path])


@pytest.mark.parametrize("mode,Sk", [("bidir", 24), ("cross", 17), ("cross", 24)])
def test_attn_forward_matches_jax(mode, Sk):
    cfg_j = jax_get_config("llama-3.2-vision-11b", smoke=True)
    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    pj = strip(JL.attn_params(jax.random.PRNGKey(3), cfg_j, cross=mode == "cross"))
    pt = _port(pj, cfg)
    rng = np.random.default_rng(1)
    x, kv = _rand(rng, 2, 24, cfg.d_model), _rand(rng, 2, Sk, cfg.d_model)
    g = _rand(rng, 2, 24, cfg.d_model)
    if mode == "bidir":
        _check(jax.jit(lambda p, x: JL.attn_forward(p, x, cfg_j, causal=False)), pj,
               lambda p, x: TL.attn_forward(p, x, cfg, causal=False), pt, [x], g)
    else:
        _check(jax.jit(lambda p, x, kv: JL.attn_forward(p, x, cfg_j, kv_src=kv)), pj,
               lambda p, x, kv: TL.attn_forward(p, x, cfg, kv_src=kv), pt, [x, kv], g)


@pytest.mark.parametrize("kind", ["bidir", "cross"])
def test_bidir_and_cross_blocks_match_jax(kind):
    arch = "whisper-tiny"
    cfg_j, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    bj, bt = JST.make_block(cfg_j, kind), TST.make_block(cfg, kind)
    pj = strip(bj.init(jax.random.PRNGKey(5)))
    pt = _port(pj, cfg)
    rng = np.random.default_rng(2)
    x, enc = _rand(rng, 2, 12, cfg.d_model), _rand(rng, 2, cfg.encoder_seq, cfg.d_model)
    g = _rand(rng, 2, 12, cfg.d_model)

    def ctx(*enc):  # the encoder output, for a cross block only
        return {"xattn": enc[0]} if enc else {}

    def fn_j(p, x, *enc):
        return bj.forward(p, x, ctx(*enc))[0]

    def fn_t(p, x, *enc):
        y, aux = bt.forward(p, x, ctx(*enc))
        assert aux == 0.0
        return y

    _check(jax.jit(fn_j), pj, fn_t, pt, [x, enc] if kind == "cross" else [x], g)
    # serving: an encoder block runs its forward, a cross block has
    # prefill and decode (tests/test_torch_cross_serving.py); neither
    # extends, as in the reference
    assert (bt.prefill is None) == (kind == "bidir") and bt.extend is None
