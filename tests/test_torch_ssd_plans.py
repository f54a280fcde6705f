"""Host-side plan of the port's SSD-scan kernel (K3), which runs on the
CPU: `ssd_scan.ops.scan_plan` picks the path (the chunk-parallel
tensor-core path for bf16 with P and N multiples of 16, the FMA path
otherwise), the chunk T, the heads per block G, the grid, the shared
memory and the scratch of the chunk chain, and raises on what neither
path takes.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import ops as k3

BF16, F32 = torch.bfloat16, torch.float32
# (B, L, H, P, N) of the main paths: zamba2-7b's server and tower stacks at
# S = 2048, mamba2-130m at S = 256, and the G each takes
MAIN = [((2, 2048, 112, 64, 64), 4), ((1, 2048, 112, 64, 64), 4),
        ((16, 256, 24, 64, 128), 2)]


def _card_cases():
    """The cases of tests/test_torch_ssd_scan_cuda.py (read from the file,
    so the two stay in step)."""
    path = Path(__file__).with_name("test_torch_ssd_scan_cuda.py")
    spec = importlib.util.spec_from_file_location("_ssd_scan_cuda_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


@pytest.mark.parametrize("shape,G", MAIN)
def test_main_paths_take_the_tensor_core_path(shape, G):
    B, L, H, P, N = shape
    plan = k3.scan_plan(*shape, BF16)
    assert plan["path"] == "tc" and plan["T"] == k3.TC_CHUNK == 128
    assert plan["G"] == G and H % G == 0
    assert plan["chunks"] == L // 128
    assert plan["grid"] == (B * (H // G) * (L // 128),)
    assert plan["smem_bytes"] <= k3.SMEM_LIMIT


def test_server_shape_runs_four_times_the_blocks_of_a_block_per_head():
    """896 blocks at zamba2-7b's server shape, where one block per (batch,
    head) gave 224; the FMA path keeps that grid."""
    assert k3.scan_plan(2, 2048, 112, 64, 64, BF16)["grid"] == (896,)
    assert k3.scan_plan(2, 2048, 112, 64, 64, F32)["grid"] == (112, 2)


def test_card_test_cases_take_the_path_their_shapes_call_for():
    cases = _card_cases()
    bf16 = [c for c in cases if c[6] == "bfloat16"]
    assert len(bf16) >= 9
    for B, L, H, P, N, _, dtype, _ in cases:
        plan = k3.scan_plan(B, L, H, P, N, getattr(torch, dtype))
        want = "tc" if dtype == "bfloat16" and P % 16 == 0 and N % 16 == 0 else "fma"
        assert plan["path"] == want, (B, L, H, P, N, dtype)
    for shape, _ in MAIN:  # the main paths are among the card's cases
        assert any(c[:5] == shape and c[6] == "bfloat16" for c in cases)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 512, 8, 64, 64), F32),      # f32: exact to 2e-5, FMA
    ((2, 2048, 112, 64, 64), F32),
    ((1, 64, 2, 8, 8), BF16),        # P, N = 8
    ((1, 64, 2, 8, 64), BF16),       # P = 8
    ((1, 64, 2, 64, 8), BF16),       # N = 8
    ((1, 64, 2, 24, 64), BF16),      # P not a multiple of 16
])
def test_f32_and_narrow_heads_take_the_fma_path(shape, dtype):
    plan = k3.scan_plan(*shape, dtype)
    assert plan["path"] == "fma" and plan["T"] == k3.FMA_TILE and plan["G"] == 1
    assert plan["grid"] == (shape[2], shape[0])
    assert plan["ring"] is None and plan["counters"] is None
    assert plan["smem_bytes"] <= k3.SMEM_LIMIT


@pytest.mark.parametrize("H", [1, 2, 3, 4, 24, 112])
def test_tensor_core_shared_memory_fits_for_every_p_and_n(H):
    """Every P, N in 16..128 (step 16): the block fits 227 KB, G divides H,
    and the S_c accumulators stay within 64 registers a thread
    (G * ceil(P / 64) * ceil(N / 64) <= 4: the source instantiates
    exactly these)."""
    for P in range(16, 129, 16):
        for N in range(16, 129, 16):
            plan = k3.scan_plan(2, 256, H, P, N, BF16)
            assert plan["path"] == "tc"
            G = plan["G"]
            assert H % G == 0 and G * -(-P // 64) * -(-N // 64) <= 4
            assert plan["smem_bytes"] <= k3.SMEM_LIMIT, (H, P, N, plan)


def test_tensor_core_scratch_and_a_ragged_last_chunk():
    """The chain's ring holds two f32 states per (batch, head), P and N
    padded to whole 64-column blocks; the counters are a ticket and a flag
    per (batch row, head group); a length past the last whole chunk adds a
    chunk (its rows past L arrive as zeros)."""
    plan = k3.scan_plan(2, 192, 4, 32, 16, BF16)
    assert plan["G"] == 4 and plan["chunks"] == 2 and plan["grid"] == (4,)
    assert plan["ring"] == (2, 4, 2, 64 * 64)
    assert plan["counters"] == (2 * 2 * 1,)
    plan = k3.scan_plan(2, 2048, 112, 64, 64, BF16)
    assert plan["ring"] == (2, 112, 2, 4096) and plan["counters"] == (112,)
    # 7.3 MB of states at the server shape: it stays in the 50 MB L2
    assert 4 * 2 * 112 * 2 * 4096 == 7_340_032
    plan = k3.scan_plan(1, 256, 2, 128, 128, BF16)
    assert plan["G"] == 1 and plan["ring"] == (1, 2, 2, 128 * 128)


@pytest.mark.parametrize("args", [
    (1, 64, 2, 256, 64, BF16),    # P beyond 128
    (1, 64, 2, 64, 192, F32),     # N beyond 128
    (0, 64, 2, 64, 64, BF16),     # empty batch
    (1, 64, 2, 64, 64, torch.float16),
])
def test_plan_raises_on_what_no_path_takes(args):
    with pytest.raises(ValueError):
        k3.scan_plan(*args)
