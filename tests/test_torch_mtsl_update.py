"""K1 (the fused MTSL update) in the PyTorch port against the JAX reference.

The port's plain version, which the wrapper runs on CPU tensors, is held
against the reference's `mtsl_update_reference` and its Pallas kernel in
interpret mode (`repro.kernels.mtsl_update.ops.mtsl_update`), on the
reference's own cases (tests/test_kernels.py): the shapes and dtypes at
1e-6 (f32) and 1e-2 (bf16), and the hypothesis sweep over n in [1, 2000]
and eta in [0, 10] at 1e-6 + 1e-6 |ref| (XLA may contract the update into
an FMA; the port rounds the product first, as its CUDA kernel does).
Per-row step sizes are checked against a loop of the reference over rows,
and the wrapper must update p in its own storage. The CUDA kernel itself is
compared with the plain version on the card in
tests/test_torch_mtsl_update_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.mtsl_update.ops import mtsl_update as jax_mtsl_update
from repro.kernels.mtsl_update.ref import mtsl_update_reference as jax_reference
from repro_torch.kernels.mtsl_update.ops import mtsl_update_
from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
from repro_torch.utils.tree import tree_leaves

TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


@pytest.mark.parametrize("shape", [(3, 5), (128,), (7, 129), (2, 3, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_update_matches_jax(shape, dtype):
    rng = np.random.default_rng(7)
    p_np, g_np = rng.normal(size=shape), rng.normal(size=shape)
    jp, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (p_np, g_np))
    p = torch.tensor(_f32(jp), dtype=getattr(torch, dtype))
    g = torch.tensor(_f32(jg), dtype=getattr(torch, dtype))
    out = mtsl_update_(p.clone(), g, 0.1)
    assert out.shape == shape and out.dtype == getattr(torch, dtype)
    for ref in (jax_reference(jp, jg, 0.1), jax_mtsl_update(jp, jg, 0.1)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype])
    assert torch.equal(out, mtsl_update_reference(p, g, 0.1))


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 2000),
    eta=st.floats(0.0, 10.0, allow_nan=False),
    seed=st.integers(0, 2**31 - 1),
)
def test_plain_update_sweep_matches_jax(n, eta, seed):
    rng = np.random.default_rng(seed)
    p_np = rng.normal(size=(n,)).astype(np.float32)
    g_np = rng.normal(size=(n,)).astype(np.float32)
    out = mtsl_update_(torch.from_numpy(p_np.copy()), torch.from_numpy(g_np), eta)
    ref = np.asarray(jax_reference(jnp.asarray(p_np), jnp.asarray(g_np), eta))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", [((10, 3, 3, 32, 32), 10), ((4, 64, 10), 4),
                                        ((6, 7), 3), ((5,), 5)])
def test_per_row_eta_is_a_loop_of_the_reference(shape, rows, dtype):
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    p = torch.tensor(rng.normal(size=shape), dtype=dt)
    g = torch.tensor(rng.normal(size=shape), dtype=dt)
    eta = torch.tensor(rng.uniform(0, 2, size=rows), dtype=torch.float32)
    eta[0] = 0.0  # a frozen (non-participating) client
    out = mtsl_update_(p.clone(), g, eta)
    pr, gr = p.reshape(rows, -1), g.reshape(rows, -1)
    for r in range(rows):
        ref = jax_reference(jnp.asarray(pr[r].float().numpy(), getattr(jnp, dtype)),
                            jnp.asarray(gr[r].float().numpy(), getattr(jnp, dtype)),
                            float(eta[r]))
        np.testing.assert_allclose(out.reshape(rows, -1)[r].float().numpy(), _f32(ref),
                                   rtol=1e-6, atol=TOL[dtype])
    assert torch.equal(out.reshape(rows, -1)[0], pr[0])  # eta 0: bit-frozen


def test_update_is_in_place_and_counts_no_cpu_launch():
    p = torch.randn(4, 6, requires_grad=True)
    g = torch.randn(4, 6)
    ptr, before = p.data_ptr(), p.detach().clone()
    launches, plain = mtsl_update_.launches, mtsl_update_reference.cuda_calls
    out = mtsl_update_(p, g, torch.full((4,), 0.5))
    assert out is p and p.data_ptr() == ptr
    assert torch.equal(p.detach(), (before - 0.5 * g))
    assert mtsl_update_.launches == launches
    assert mtsl_update_reference.cuda_calls == plain


def test_rows_must_divide_the_leaf():
    with pytest.raises(RuntimeError):
        mtsl_update_(torch.zeros(7), torch.zeros(7), torch.ones(2))


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
def test_fused_apply_matches_the_unfused_composition(opt_name):
    """per_component_lr's in-place apply (K1's path) against the
    reference's composition, written out with the port's own pieces:
    base update -> x ComponentLR -> x participation -> apply_updates.
    One rounding apart, so within 1e-6 after two steps."""
    from repro_torch.core.split import is_client_path
    from repro_torch.optim import adamw, apply_updates, momentum, sgd
    from repro_torch.optim.per_component import ComponentLR, per_component_lr

    rng = np.random.default_rng(0)
    M = 4

    def tree(seed):
        r = np.random.default_rng(seed)
        return {"towers": {"w": torch.tensor(r.normal(size=(M, 3, 5)), dtype=torch.float32)},
                "server": {"w": torch.tensor(r.normal(size=(5, 2)), dtype=torch.float32),
                           "b": torch.tensor(r.normal(size=(2,)), dtype=torch.float32)}}

    base = {"sgd": sgd(0.3), "momentum": momentum(0.3), "adamw": adamw(0.01)}[opt_name]
    opt = per_component_lr(base, is_client_path)
    clr = ComponentLR(torch.tensor(0.25), torch.tensor(rng.uniform(0.5, 2, M), dtype=torch.float32))
    part = torch.tensor([1.0, 0.0, 1.0, 1.0])
    fused, plain = tree(1), tree(1)
    s_fused = s_plain = opt.init(fused)
    for step in range(2):
        grads = tree(10 + step)
        s_fused = opt.apply_(fused, grads, s_fused, step, clr, part)
        upd, s_plain = opt.update(grads, s_plain, plain, step, clr)
        upd = {**upd, "towers": {k: u * part.reshape((M, 1, 1)) for k, u in upd["towers"].items()}}
        plain = apply_updates(plain, upd)
    for a, b in zip(tree_leaves(fused), tree_leaves(plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(fused["towers"]["w"][1], tree(1)["towers"]["w"][1])  # frozen
