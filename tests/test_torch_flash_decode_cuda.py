"""The port's CUDA flash-decode kernel against its plain PyTorch version,
on the card. Marked `cuda`: it skips without one (a CUDA kernel has no CPU
mode). The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_flash_decode_cuda.py

Cases: the reference's DECODE_CASES shapes (tests/test_kernels.py), a
windowed case with every row's window past the first KV tile, and the
gemma3-12b shapes, zamba2-7b's (D = 112) and the self-attention decodes
of deepseek-moe-16b, llama-3.2-vision-11b and whisper-tiny as they are
served. Tolerance 2e-5 in f32 (reduction order), 2e-2 in bf16.
Then the serving modes of the rest of the zoo, in bf16 and f32: ring
decode (kv_valid = min(pos + 1, cap), no q_offset, no window) at
mistral-nemo-12b-swa's cap 4096 (Hq 32, Hkv 8, D 128), and cross decode
over every key of a source at llama-3.2-vision's 1601 patches (G 4, D 128)
and whisper-tiny's 1500 frames (G 1, D 64), caps that are not multiples
of the 64-row split, counted under their mode.

The bf16 kernel (split-KV over fixed runs of 64 cache rows, merged in the
same launch) is also held at every G, at caps that are not multiples of 64,
with kv_valid of 0, 1 and cap, and for what its design promises: the same
rows give bit-equal outputs in a cap-320 and a cap-4096 buffer, two
launches are bit-equal, and its counters are left at zero.
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
    # bf16 split-KV: every G, caps that are not multiples of 64, windows
    (3, 200, 8, 8, 128, 0, "bfloat16", False),
    (3, 200, 8, 4, 64, 0, "bfloat16", False),
    (5, 320, 16, 8, 256, 1024, "bfloat16", False),
    (4, 1000, 16, 4, 256, 0, "bfloat16", False),
    (2, 777, 16, 2, 96, 100, "bfloat16", True),
    (2, 4096, 16, 8, 256, 0, "bfloat16", False),
    # zamba2-7b's shared attention in the hybrid-serve decode (4 slots, MHA,
    # D = 112) and the same in f32
    (4, 320, 32, 32, 112, 0, "bfloat16", False),
    (4, 320, 32, 32, 112, 0, "float32", False),
    # the self-attention decodes of the rest of the zoo as served:
    # deepseek-moe-16b (MHA, D = 128; 4 slots, and M b = 8 server rows in
    # the sequential engine), llama-3.2-vision-11b (GQA 4, M b = 4 rows),
    # whisper-tiny's decoder (MHA, D = 64, M b = 8 rows, cap 96)
    (4, 288, 16, 16, 128, 0, "bfloat16", False),
    (8, 288, 16, 16, 128, 0, "bfloat16", False),
    (4, 288, 32, 8, 128, 0, "bfloat16", False),
    (8, 96, 6, 6, 64, 0, "bfloat16", False),
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
    n, plain = flash_decode.counts.total(), decode_reference.cuda_calls
    out = flash_decode(q, k, v, **kw)
    assert flash_decode.counts.total() == n + 1
    assert decode_reference.cuda_calls == plain
    torch.testing.assert_close(out.float(), decode_reference(q, k, v, **kw).float(),
                               rtol=0, atol=TOL[dtype])


MODE_CASES = [  # (mode, B, cap, Hq, Hkv, D)
    ("ring", 2, 4096, 32, 8, 128),
    ("cross", 4, 1601, 32, 8, 128),
    ("cross", 8, 1500, 6, 6, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", MODE_CASES)
def test_cuda_ring_and_cross_modes_match_plain(case, dtype):
    _skip_without_card()
    mode, B, cap, Hq, Hkv, D = case
    q, k, v, _ = _inputs((B, cap, Hq, Hkv, D, 0, dtype, False), seed=15)
    if mode == "ring":  # rows before, at and past the wrap: min(pos + 1, cap)
        pos = torch.tensor([100, 9000][:B], dtype=torch.int32, device="cuda")
        kv_valid = torch.clamp(pos + 1, max=cap)
    else:  # every key of the source
        kv_valid = torch.full((B,), cap, dtype=torch.int32, device="cuda")
    before = flash_decode.counts.read()
    out = flash_decode(q, k, v, kv_valid=kv_valid, mode=mode)
    after = flash_decode.counts.read()
    assert {m: after[m] - before[m] for m in after} == {
        m: int(m == mode) for m in after}
    torch.testing.assert_close(out.float(),
                               decode_reference(q, k, v, kv_valid=kv_valid).float(),
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


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1024, 7])
def test_cuda_bf16_kv_valid_0_1_and_cap(window):
    """kv_valid 0 (nothing visible: 0), 1 (one row) and cap (all rows)."""
    _skip_without_card()
    q, k, v, _ = _inputs((3, 320, 16, 8, 256, 0, "bfloat16", False), seed=12)
    kv_valid = torch.tensor([0, 1, 320], dtype=torch.int32, device="cuda")
    kw = dict(kv_valid=kv_valid, q_offset=kv_valid - 1, window=window)
    out = flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0
    torch.testing.assert_close(out.float(), decode_reference(q, k, v, **kw).float(),
                               rtol=0, atol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1024])
def test_cuda_bf16_output_does_not_depend_on_cap(window):
    """The same visible rows in a cap-320 and a cap-4096 buffer (the rest
    filled with other values) give bit-equal outputs: the split boundaries
    are absolute, and splits past kv_valid do nothing."""
    _skip_without_card()
    q, k, v, _ = _inputs((4, 320, 16, 8, 256, 0, "bfloat16", False), seed=13)
    big_k, big_v = (torch.randn(4, 4096, 8, 256, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    big_k[:, :320], big_v[:, :320] = k, v
    kv_valid = torch.tensor([1, 64, 200, 320], dtype=torch.int32, device="cuda")
    kw = dict(kv_valid=kv_valid, q_offset=kv_valid - 1, window=window)
    assert torch.equal(flash_decode(q, k, v, **kw), flash_decode(q, big_k, big_v, **kw))


@pytest.mark.cuda
def test_cuda_bf16_two_launches_are_bit_equal_and_counters_stay_zero():
    _skip_without_card()
    from repro_torch.kernels.flash_decode import ops

    q, k, v, kw = _inputs((8, 4096, 16, 8, 256, 0, "bfloat16", False), seed=14)
    a = flash_decode(q, k, v, **kw)
    b = flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    for c in ops._COUNTERS.values():
        assert int(c.abs().sum()) == 0
