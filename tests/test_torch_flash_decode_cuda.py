"""The port's CUDA flash-decode kernel against its plain PyTorch version,
on the card. Marked `cuda`: it skips without one (a CUDA kernel has no CPU
mode). The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_flash_decode_cuda.py

Cases: the reference's DECODE_CASES shapes (tests/test_kernels.py), a
windowed case with every row's window past the first KV tile, and the
gemma3-12b shapes. Tolerance 2e-5 in f32 (reduction order), 2e-2 in bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_reference

CASES = [
    # (B, cap, Hq, Hkv, D, window, dtype, windowed q_offset)
    (4, 64, 4, 2, 32, 0, "float32", False),
    (3, 96, 8, 1, 16, 0, "float32", False),
    (2, 128, 4, 4, 64, 0, "float32", False),
    (4, 64, 6, 3, 32, 16, "float32", False),
    (2, 64, 4, 2, 64, 0, "bfloat16", False),
    (4, 128, 4, 2, 32, 24, "float32", True),
    (8, 512, 16, 8, 256, 1024, "bfloat16", False),
    (8, 4096, 16, 8, 256, 1024, "bfloat16", False),
    (8, 512, 16, 8, 256, 1024, "float32", False),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=11):
    B, cap, Hq, Hkv, D, window, dtype, windowed = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=dt, device="cuda")
               for s in ((B, 1, Hq, D), (B, cap, Hkv, D), (B, cap, Hkv, D)))
    if windowed:
        kv_valid = rng.integers(3 * window, cap + 1, size=(B,))
    else:
        kv_valid = np.array(rng.integers(1, cap + 1, size=(B,)).tolist()[:-1] + [cap])
    kv_valid = torch.tensor(kv_valid, dtype=torch.int32, device="cuda")
    return q, k, v, dict(kv_valid=kv_valid, q_offset=kv_valid - 1, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dtype = case[6]
    q, k, v, kw = _inputs(case)
    n, plain = flash_decode.launches, decode_reference.cuda_calls
    out = flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_decode.launches == n + 1
    assert decode_reference.cuda_calls == plain
    torch.testing.assert_close(out.float(), decode_reference(q, k, v, **kw).float(),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_reads_a_slot_view_and_rejects_bad_input():
    """A slot's cache is a strided view of the pool: the kernel reads it in
    place. Mismatched dtypes and unaligned rows raise instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, kw = _inputs((4, 64, 4, 2, 32, 0, "float32", False))
    sub = dict(kv_valid=kw["kv_valid"][1:3].contiguous(),
               q_offset=kw["q_offset"][1:3].contiguous(), window=0)
    out = flash_decode(q[1:3].contiguous(), k[1:3], v[1:3], **sub)
    ref = flash_decode(q, k, v, **kw)[1:3]
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError):
        flash_decode(q, k.double(), v, **kw)
    k_odd = torch.cat([k, k[..., :1]], dim=-1)[..., 1:]  # row stride 33
    v_odd = torch.cat([v, v[..., :1]], dim=-1)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        flash_decode(q, k_odd, v_odd, **kw)
