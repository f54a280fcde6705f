"""The kernels' meta branch leaves the card's path alone: on CUDA tensors
each wrapper launches its kernel, counts the launch where it always has,
and adds nothing to the dry-run's tally (`kernels.counts.META`); a meta
call in between counts nothing on the card. Marked `cuda`: it skips
without a card. The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_dryrun_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.counts import META
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
from repro_torch.kernels.ssd_scan.ops import ssd_scan


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _inputs(device):
    g = torch.Generator().manual_seed(0)
    attn = [torch.randn(2, 128, h, 64, generator=g).to(torch.bfloat16).to(device)
            for h in (4, 2, 2)]
    B, L, H, P, N = 1, 128, 4, 64, 64
    scan = [torch.randn(B, L, H, P, generator=g).to(torch.bfloat16),
            torch.rand(B, L, H, generator=g) * 0.1 + 0.01,
            -torch.rand(H, generator=g) - 0.5,
            torch.randn(B, L, N, generator=g).to(torch.bfloat16),
            torch.randn(B, L, N, generator=g).to(torch.bfloat16)]
    cache = torch.randn(2, 128, 2, 64, generator=g).to(torch.bfloat16)
    q = torch.randn(2, 1, 4, 64, generator=g).to(torch.bfloat16)
    p, d = torch.randn(64, 32, generator=g), torch.randn(64, 32, generator=g)
    return ([t.to(device) for t in attn], [t.to(device) for t in scan],
            [t.to(device) for t in (q, cache)], [t.to(device) for t in (p, d)])


def _run_all(device):
    (q, k, v), (x, dt, A, Bm, Cm), (qd, cache), (p, d) = _inputs(device)
    out = flash_attention(q, k, v, causal=True)
    ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    flash_decode(qd, cache, cache, kv_valid=100)
    mtsl_update_multi_([p], [d], [0.1])
    return out, (q, k, v)


@pytest.mark.cuda
def test_cuda_calls_launch_and_leave_the_meta_tally_alone():
    _need_card()
    META.reset()
    flash_attention.launches = mtsl_update_multi_.launches = 0
    flash_decode.counts.reset()
    ssd_scan.counts.reset()
    out, (q, k, v) = _run_all("cuda")
    torch.cuda.synchronize()
    assert META.by_kernel == {}
    assert flash_attention.launches == 1 and mtsl_update_multi_.launches == 1
    assert flash_decode.counts.total() == 1 and ssd_scan.counts.total() == 1
    ref = mha_reference(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    # a dry-run call between card calls counts nothing on the card
    _run_all("meta")
    assert flash_attention.launches == 1 and mtsl_update_multi_.launches == 1
    assert flash_decode.counts.total() == 1 and ssd_scan.counts.total() == 1
    assert {k: v["launches"] for k, v in META.by_kernel.items()} == {
        "flash_attention": 1, "ssd_scan": 1, "flash_decode": 1,
        "mtsl_update_multi_": 1}
    META.reset()
