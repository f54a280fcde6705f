"""The port's CUDA flash-attention kernel (K2) against its plain PyTorch
version, on the card. Marked `cuda`: it skips without one (a CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_flash_attention_cuda.py

Cases: the reference's FLASH_CASES shapes that are causal
(tests/test_kernels.py), GQA, windows, a ragged S, strided q/k/v (views of
a fused projection), and the zamba2-7b path's shape (B = 2, H = 32,
S = 2048, D = 112). Tolerance 2e-5 in f32 (reduction order), 2e-2 in bf16.
Also a row with no visible key: the kernel gives 0, as the TPU kernel does.

The bf16 kernel (wgmma, TMA) is also held over a grid of head dims (each
tile configuration of ops.tile_config), masks and lengths that are not
tile multiples, with K2's relative L2 limit of 5e-3 beside the elementwise
one; with GQA 4, D = 24 (padded to a 16-wide k-step), strided views, no
causal mask, and two launches that must be bit-equal.

Without the causal mask, as the encoder-decoder and the VLM call it:
non-causal self-attention (whisper-tiny's encoder at D = 64) and cross
attention with Sq != Sk and a ragged Sk (whisper's 1500 frames,
llama-3.2-vision's 1601 patches), in bf16 and f32, with the mode counters
(read from the call's mode, not its shape), bit-equal repeats, and the
gradients of a cross call.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_reference

CASES = [
    # (B, S, Hq, Hkv, D, window, dtype)
    (2, 64, 4, 2, 32, 0, "float32"),
    (1, 128, 2, 2, 64, 16, "float32"),
    (1, 96, 4, 1, 16, 0, "float32"),
    (1, 64, 4, 4, 128, 0, "bfloat16"),
    (1, 80, 2, 1, 64, 24, "float32"),
    (2, 200, 4, 4, 112, 0, "float32"),
    (1, 300, 8, 2, 256, 100, "bfloat16"),
    (2, 2048, 32, 32, 112, 0, "bfloat16"),  # zamba2-7b's shared attention
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL_L2 = {"float32": 2e-5, "bfloat16": 5e-3}
BF16_GRID = [  # (B, S, Hq, Hkv, D, window, "bfloat16")
    (1, S, 2, 1, D, window, "bfloat16")
    for D in (64, 112, 128, 256) for window in (0, 100, 1024)
    for S in (200, 1000, 2048)
]
BF16_MORE = [
    (2, 1000, 16, 4, 112, 0, "bfloat16"),   # GQA 4
    (2, 300, 4, 2, 24, 0, "bfloat16"),      # D = 24: one 16-wide step padded
    (1, 130, 2, 2, 8, 16, "bfloat16"),      # D = 8, a window inside a tile
]


def _inputs(case, seed=0):
    B, S, Hq, Hkv, D, _, dtype = case
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(B, S, h, D)), dtype=getattr(torch, dtype),
                         device="cuda") for h in (Hq, Hkv, Hkv)]


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case):
    _skip_without_card()
    window, dtype = case[5], case[6]
    q, k, v = _inputs(case)
    n, plain = flash_attention.launches, mha_reference.cuda_calls
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert mha_reference.cuda_calls == plain
    ref = mha_reference(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


def _check_bf16(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= REL_L2["bfloat16"], rel


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_GRID + BF16_MORE)
def test_cuda_bf16_kernel_matches_plain(case):
    _skip_without_card()
    q, k, v = _inputs(case, seed=5)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=case[5])
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _check_bf16(out, mha_reference(q, k, v, causal=True, window=case[5]))


@pytest.mark.cuda
def test_cuda_bf16_kernel_without_causal_mask():
    """causal=False with a window: a row sees the keys j with i - j < w,
    the later ones included."""
    _skip_without_card()
    q, k, v = _inputs((1, 300, 4, 2, 64, 50, "bfloat16"), seed=6)
    out = flash_attention(q, k, v, causal=False, window=50)
    _check_bf16(out, mha_reference(q, k, v, causal=False, window=50))


@pytest.mark.cuda
def test_cuda_bf16_kernel_reads_strided_views():
    """bf16 q, k, v as views of one fused [B, S, 3, H, D] projection: the
    TMA maps walk the strides."""
    _skip_without_card()
    rng = np.random.default_rng(7)
    qkv = torch.tensor(rng.normal(size=(2, 333, 3, 4, 112)), dtype=torch.bfloat16,
                       device="cuda")
    q, k, v = qkv.unbind(2)
    out = flash_attention(q, k, v, causal=True, window=0)
    _check_bf16(out, mha_reference(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 2048, 32, 32, 112, 0, "bfloat16"),
                                  (1, 1000, 8, 2, 256, 100, "bfloat16")])
def test_cuda_bf16_two_launches_are_bit_equal(case):
    _skip_without_card()
    q, k, v = _inputs(case, seed=8)
    a = flash_attention(q, k, v, causal=True, window=case[5])
    b = flash_attention(q, k, v, causal=True, window=case[5])
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views():
    """q, k, v as views of one fused [B, S, 3, H, D] projection."""
    _skip_without_card()
    rng = np.random.default_rng(3)
    qkv = torch.tensor(rng.normal(size=(2, 70, 3, 4, 32)), dtype=torch.float32,
                       device="cuda")
    q, k, v = qkv.unbind(2)
    out = flash_attention(q, k, v, causal=True, window=0)
    ref = mha_reference(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_cuda_gradients_match_plain():
    _skip_without_card()
    q, k, v = (t.requires_grad_() for t in _inputs((1, 96, 4, 2, 32, 24, "float32")))
    g = torch.randn_like(q)
    grads = torch.autograd.grad((flash_attention(q, k, v, True, 24) * g).sum(), (q, k, v))
    want = torch.autograd.grad((mha_reference(q, k, v, causal=True, window=24) * g).sum(),
                               (q, k, v))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_row_with_no_visible_key_is_zero():
    """Sq = 8 queries over Sk = 4 keys, causal with a window of 1: row i
    sees only key i, so rows 4..7 see none and must be 0."""
    _skip_without_card()
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.normal(size=(1, 8, 2, 16)), dtype=torch.float32, device="cuda")
    k, v = (torch.tensor(rng.normal(size=(1, 4, 2, 16)), dtype=torch.float32,
                         device="cuda") for _ in range(2))
    out = flash_attention(q, k, v, causal=True, window=1)
    torch.cuda.synchronize()
    assert float(out[:, 4:].abs().max()) == 0.0
    ref = mha_reference(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out[:, :4], ref[:, :4], atol=2e-5, rtol=2e-5)


# non-causal self-attention (Sq == Sk) and cross attention (Sq != Sk) as
# the encoder-decoder and the VLM run them: (B, Sq, Sk, Hq, Hkv, D, dtype)
NONCAUSAL_CASES = [
    (2, 300, 300, 6, 6, 64, "bfloat16"),     # whisper-tiny's encoder, DP = 64
    (2, 1500, 1500, 6, 6, 64, "bfloat16"),   # its 1500 frames (ragged: 23.4 tiles)
    (4, 448, 1500, 6, 6, 64, "bfloat16"),    # its decoder's cross attention
    (1, 100, 37, 4, 2, 64, "bfloat16"),      # D = 64, Sk inside one tile
    (1, 2048, 1601, 32, 8, 128, "bfloat16"),  # llama-3.2-vision's cross attention
    (2, 130, 257, 8, 2, 112, "bfloat16"),    # DP = 128, Sk past two tiles
    (1, 77, 200, 4, 4, 256, "bfloat16"),
    (2, 200, 333, 4, 2, 64, "float32"),
    (1, 64, 17, 4, 2, 32, "float32"),        # the smoke VLM's shape
    (2, 90, 90, 4, 4, 32, "float32"),
]


def _qkv(case, seed):
    B, Sq, Sk, Hq, Hkv, D, dtype = case
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(B, S, h, D)), dtype=getattr(torch, dtype),
                         device="cuda") for S, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NONCAUSAL_CASES)
def test_cuda_kernel_without_causal_mask_and_cross(case):
    """No mask but the keys' end: each row sees all Sk keys (TMA zero-fills
    the tile past Sk; the kernel masks j >= Sk). Called as non-causal self
    attention (the cases with Sq == Sk) or as cross attention, and counted
    so; two launches bit-equal."""
    _skip_without_card()
    q, k, v = _qkv(case, seed=9)
    n, nb, nc = (flash_attention.launches, flash_attention.launches_bidir,
                 flash_attention.launches_cross)
    cross = case[1] != case[2]
    out = flash_attention(q, k, v, causal=False, cross=cross)
    again = flash_attention(q, k, v, causal=False, cross=cross)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_bidir,
            flash_attention.launches_cross) == (n + 2, nb + 2 * (not cross),
                                                nc + 2 * cross)
    assert torch.equal(out, again)
    ref = mha_reference(q, k, v, causal=False)
    if case[-1] == "bfloat16":
        _check_bf16(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.cuda
def test_cuda_cross_call_counted_by_its_mode_not_its_shape():
    """A cross call whose query length equals Sk (a VLM at S = 1601) counts
    as cross, a non-causal self call with Sq != Sk as non-causal self."""
    _skip_without_card()
    same = _qkv((1, 64, 64, 4, 2, 32, "float32"), 11)
    ragged = _qkv((1, 64, 17, 4, 2, 32, "float32"), 12)
    n, nb, nc = (flash_attention.launches, flash_attention.launches_bidir,
                 flash_attention.launches_cross)
    flash_attention(*same, causal=False, cross=True)
    flash_attention(*ragged, causal=False)
    assert (flash_attention.launches, flash_attention.launches_bidir,
            flash_attention.launches_cross) == (n + 2, nb + 1, nc + 1)


@pytest.mark.cuda
def test_cuda_cross_attention_gradients_match_plain():
    _skip_without_card()
    q, k, v = (t.requires_grad_() for t in _qkv((2, 24, 17, 4, 2, 32, "float32"), 10))
    g = torch.randn_like(q)
    grads = torch.autograd.grad(
        (flash_attention(q, k, v, causal=False, cross=True) * g).sum(), (q, k, v))
    want = torch.autograd.grad((mha_reference(q, k, v, causal=False) * g).sum(),
                               (q, k, v))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
