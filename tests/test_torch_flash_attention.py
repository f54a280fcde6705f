"""The port's flash attention (K2's plain version and its autograd
wrapper) against the JAX reference: `repro.kernels.flash_attention.ops.
flash_attention` (the Pallas kernel in interpret mode) and `mha_reference`,
on the same numpy inputs in the model's [B, S, H, D] layout. Cases: causal,
a sliding window, GQA, S not a multiple of the kernel's block, as in
tests/test_kernels.py. Tolerances: f32 outputs within 2e-5, gradients
through the wrapper (which recomputes through the plain version) within
1e-4 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import mha_reference as jax_mha
from repro_torch.kernels.flash_attention import flash_attention, mha_reference

CASES = [
    # (B, S, Hq, Hkv, D, window)
    (2, 64, 4, 2, 32, 0),      # causal, GQA 2
    (1, 128, 2, 2, 64, 16),    # window
    (1, 96, 4, 1, 16, 0),      # GQA 4, S not a multiple of the block
    (1, 80, 2, 1, 64, 24),     # window past the block residue
    (2, 40, 4, 4, 112, 0),     # zamba2's head_dim, S below one block
]


def _inputs(case, seed=0):
    B, S, Hq, Hkv, D, _ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_kernel_and_reference(case):
    window = case[-1]
    arrs = _inputs(case)
    out = flash_attention(*map(torch.tensor, arrs), causal=True, window=window)
    got = mha_reference(*map(torch.tensor, arrs), causal=True, window=window)
    assert torch.equal(out, got)  # on the CPU the wrapper is the plain version
    ja = list(map(jnp.asarray, arrs))
    for want in (jax_flash(*ja, True, window, 32, 32),  # interpret mode
                 jax_mha(*ja, causal=True, window=window)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_gradients_match_jax(case):
    window = case[-1]
    arrs = _inputs(case, seed=1)
    g = np.random.default_rng(2).normal(size=arrs[0].shape).astype(np.float32)

    def f_jax(q, k, v):
        return jnp.sum(jax_flash(q, k, v, True, window, 16, 16) * g)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    t = [torch.tensor(a, requires_grad=True) for a in arrs]
    (flash_attention(*t, causal=True, window=window) * torch.tensor(g)).sum().backward()
    for a, w in zip(t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_plain_calls_on_the_cpu_are_not_counted():
    n, c = flash_attention.launches, mha_reference.cuda_calls
    flash_attention(*map(torch.tensor, _inputs(CASES[0])))
    assert (flash_attention.launches, mha_reference.cuda_calls) == (n, c)
