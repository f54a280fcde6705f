"""Flash-decode in the PyTorch port against the JAX reference.

The port's plain version (what the wrapper runs on CPU tensors) is held
against the reference's Pallas kernel in interpret mode and against its
`decode_reference`, on the reference's own DECODE_CASES
(tests/test_kernels.py) plus a windowed case with explicit `q_offset`.
Inputs are drawn with numpy and handed to both packages. Tolerance: 2e-5
in f32 (reduction order only), 2e-2 in bf16 (the reference's kernel
tolerances). The CUDA kernel itself is compared with the plain version on
the card in tests/test_torch_flash_decode_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import decode_reference as jax_decode_reference
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_reference

DECODE_CASES = [
    # (B, cap, Hq, Hkv, D, window, block_k, dtype, explicit q_offset)
    (4, 64, 4, 2, 32, 0, 16, "float32", False),   # GQA, multi-split KV
    (3, 96, 8, 1, 16, 0, 32, "float32", False),   # MQA, non-pow2 cap
    (2, 128, 4, 4, 64, 0, 128, "float32", False),  # MHA, single split
    (4, 64, 6, 3, 32, 16, 16, "float32", False),  # sliding window
    (2, 64, 4, 2, 64, 0, 32, "bfloat16", False),
    (4, 128, 4, 2, 32, 24, 16, "float32", True),  # window, q_offset past it
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=11):
    B, cap, Hq, Hkv, D, window, _, _, explicit = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, cap, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, cap, Hkv, D)).astype(np.float32)
    if explicit:  # every row's window starts past the first KV split
        kv_valid = rng.integers(3 * window, cap + 1, size=(B,))
    else:  # ragged per-row fill: includes 1 (just admitted) and cap (full)
        kv_valid = np.array(rng.integers(1, cap + 1, size=(B,)).tolist()[:-1] + [cap])
    q_offset = kv_valid - 1
    return q, k, v, kv_valid.astype(np.int32), q_offset.astype(np.int32)


def _torch(a, dtype):
    return torch.tensor(a, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_plain_decode_matches_jax(case):
    B, cap, Hq, Hkv, D, window, block_k, dtype, _ = case
    q, k, v, kv_valid, q_offset = _inputs(case)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    kern = jax_flash_decode(jq, jk, jv, kv_valid=jnp.asarray(kv_valid),
                            q_offset=jnp.asarray(q_offset), window=window,
                            block_k=block_k, interpret=True)
    ref = jax_decode_reference(jq, jk, jv, kv_valid=jnp.asarray(kv_valid),
                               q_offset=jnp.asarray(q_offset), window=window)
    out = flash_decode(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                       kv_valid=torch.tensor(kv_valid),
                       q_offset=torch.tensor(q_offset), window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, 1, Hq, D)
    got = out.float().numpy()
    for want in (kern, ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=0)


def test_wrapper_runs_plain_version_on_cpu_uncounted():
    q, k, v, kv_valid, _ = _inputs(DECODE_CASES[0])
    q, k, v = (torch.tensor(a) for a in (q, k, v))
    before = (flash_decode.counts.read(), decode_reference.cuda_calls)
    out = flash_decode(q, k, v, kv_valid=torch.tensor(kv_valid))
    torch.testing.assert_close(
        out, decode_reference(q, k, v, kv_valid=torch.tensor(kv_valid)),
        rtol=0, atol=0)
    assert (flash_decode.counts.read(), decode_reference.cuda_calls) == before


def test_row_without_visible_slot_is_zero():
    """kv_valid == 0, or a window that starts past every live slot, gives
    zeros, as the kernel does."""
    q, k, v, kv_valid, _ = _inputs(DECODE_CASES[0])
    q, k, v = (torch.tensor(a) for a in (q, k, v))
    kv_valid[0] = 0
    out = flash_decode(q, k, v, kv_valid=torch.tensor(kv_valid),
                       q_offset=torch.tensor([5, 200, 200, 200]), window=8)
    assert torch.all(out[0] == 0) and torch.all(out[1:] == 0)
    assert torch.isfinite(out).all()
