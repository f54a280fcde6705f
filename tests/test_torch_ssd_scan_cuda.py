"""The port's CUDA SSD-scan kernel (K3) against its plain PyTorch version,
on the card. Marked `cuda`: it skips without one (a CUDA kernel has no CPU
mode). The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_ssd_scan_cuda.py

Cases: the reference's SSD_CASES shapes (tests/test_kernels.py), a length
that is not a multiple of the FMA path's 64-position tile, a nonzero
initial state, the shapes of the LM path (zamba2-7b's server and tower,
mamba2-130m's), serving's extend shapes (one row of one 128-position
chunk resumed from an f32 state: mamba2-130m's and zamba2-7b's), and the
tensor-core path (bf16, P and N multiples of 16) with an initial state, at N = 128, at P = 128, with P and N below one
64-column block, with a ragged last chunk and with an odd head count (one
head per block). Each launch counts itself on the card by path
(`ssd_scan.counts`: "tc" for the tensor-core path, "fma" for the other,
as `scan_plan` picks them), and a repeat launch
must be bit-equal. Tolerances: y within 2e-5 in f32 and 5e-2 in bf16, the
final state within 1e-4 (relative to its largest entry at the full-width
shapes, where the state sums thousands of terms).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan.ops import scan_plan, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_reference

CASES = [
    # (B, L, H, P, N, chunk, dtype, initial state)
    (2, 64, 3, 8, 16, 16, "float32", False),
    (1, 128, 2, 16, 8, 32, "float32", False),
    (2, 32, 1, 4, 4, 32, "float32", False),
    (1, 64, 4, 32, 64, 16, "float32", False),
    (1, 64, 2, 8, 8, 16, "bfloat16", False),
    (2, 48, 3, 8, 16, 16, "float32", False),   # ragged last tile
    (2, 96, 2, 16, 32, 32, "float32", True),   # initial state
    (2, 2048, 112, 64, 64, 128, "bfloat16", False),  # zamba2-7b server
    (1, 2048, 112, 64, 64, 128, "bfloat16", False),  # zamba2-7b tower
    (16, 256, 24, 64, 128, 128, "bfloat16", False),  # mamba2-130m
    # the tensor-core path off the main shapes
    (2, 512, 8, 64, 64, 128, "bfloat16", True),    # initial state
    (2, 256, 4, 64, 128, 128, "bfloat16", True),   # N = 128, initial state
    (1, 384, 4, 128, 64, 128, "bfloat16", True),   # P = 128
    (1, 256, 2, 128, 128, 128, "bfloat16", False),  # P = N = 128
    (2, 192, 4, 32, 16, 64, "bfloat16", False),    # padded blocks, ragged chunk
    (1, 256, 3, 48, 80, 128, "bfloat16", True),    # odd H: one head a block
    # serving's chunked extend: one row, one chunk, resumed from a state
    (1, 128, 24, 64, 128, 128, "bfloat16", True),  # mamba2-130m
    (1, 128, 112, 64, 64, 128, "bfloat16", True),  # zamba2-7b
]
# the main paths' shapes (zamba2-7b server and tower, mamba2-130m, and the
# two extend shapes)
MAIN = CASES[7:10] + CASES[16:18]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(case, seed=2):
    B, L, H, P, N, _, dtype, with_state = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(a, d=dt):
        return torch.tensor(a, dtype=d, device="cuda")

    f32 = torch.float32
    x = t(rng.normal(size=(B, L, H, P)))
    dtv = t(rng.uniform(0.01, 0.2, size=(B, L, H)), f32)
    A = t(-rng.uniform(0.5, 2.0, size=(H,)), f32)
    Bm, Cm = t(rng.normal(size=(B, L, N))), t(rng.normal(size=(B, L, N)))
    h0 = t(rng.normal(size=(B, H, P, N)), f32) if with_state else None
    return x, dtv, A, Bm, Cm, h0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    chunk, dtype = case[5], case[6]
    x, dtv, A, Bm, Cm, h0 = _inputs(case)
    before, plain = ssd_scan.counts.read(), ssd_reference.cuda_calls
    y, st = ssd_scan(x, dtv, A, Bm, Cm, chunk=chunk, initial_state=h0)
    after = ssd_scan.counts.read()
    path = scan_plan(*x.shape, Bm.shape[-1], x.dtype)["path"]
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == path) for k in after}
    assert ssd_reference.cuda_calls == plain
    yr, sr = ssd_reference(x, dtv, A, Bm, Cm, chunk=chunk, initial_state=h0)
    assert y.dtype == x.dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), atol=TOL[dtype], rtol=TOL[dtype])
    scale = max(1.0, float(sr.abs().max()))
    assert float((st - sr).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, dtv, A, Bm, Cm, _ = _inputs((1, 64, 2, 8, 8, 16, "float32", False))
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, dtv.double(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="P, N"):
        big = torch.zeros(1, 64, 1, 256, device="cuda")
        ssd_scan(big, dtv[..., :1].contiguous(), A[:1], Bm, Cm, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MAIN)
def test_cuda_main_path_shapes_take_the_tensor_core_path(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, dtv, A, Bm, Cm, h0 = _inputs(case)
    before = ssd_scan.counts.read()
    ssd_scan(x, dtv, A, Bm, Cm, chunk=case[5], initial_state=h0)
    after = ssd_scan.counts.read()
    assert (after["tc"], after["fma"]) == (before["tc"] + 1, before["fma"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CASES[7], CASES[9], CASES[10], CASES[6]])
def test_cuda_repeat_launch_is_bit_equal(case):
    """Every sum runs in a fixed order (the chunk chain too), so two
    launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, dtv, A, Bm, Cm, h0 = _inputs(case, seed=5)
    y1, s1 = ssd_scan(x, dtv, A, Bm, Cm, chunk=case[5], initial_state=h0)
    y2, s2 = ssd_scan(x, dtv, A, Bm, Cm, chunk=case[5], initial_state=h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[16:18])
def test_cuda_extend_chunk_resumes_a_slot_of_the_pool(case):
    """Serving's extend: the initial state is a slot's view of a [slots, H,
    P, N] pool, and the steps past n_valid = 64 have dt = 0 and zero
    inputs (mamba_extend's padding), so the final state equals the scan
    over the real steps alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, dtv, A, Bm, Cm, h0 = _inputs(case, seed=7)
    pool = torch.zeros((3,) + tuple(h0.shape[1:]), dtype=torch.float32, device="cuda")
    pool[1:2] = h0
    n_valid = 64
    for t in (x, dtv, Bm, Cm):
        t[:, n_valid:] = 0
    n_tc = ssd_scan.counts.read()["tc"]
    y, st = ssd_scan(x, dtv, A, Bm, Cm, chunk=case[5], initial_state=pool[1:2])
    assert ssd_scan.counts.read()["tc"] == n_tc + 1
    yr, sr = ssd_reference(x, dtv, A, Bm, Cm, chunk=case[5], initial_state=h0)
    torch.testing.assert_close(y.float(), yr.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
    real = [t[:, :n_valid] for t in (x, dtv, Bm, Cm)]
    _, s_real = ssd_reference(real[0], real[1], A, real[2], real[3], chunk=n_valid,
                              initial_state=h0)
    scale = max(1.0, float(s_real.abs().max()))
    assert float((st - s_real).abs().max()) <= 1e-4 * scale
    assert torch.equal(pool[1:2], h0)  # the kernel reads the view, never writes it
