"""Host-side plans of the port's attention kernels, which run on the CPU:
K2's tiles per head dim (`flash_attention.ops.tile_config`), K4's split
count and scratch shapes (`flash_decode.ops.split_plan`), and the layout
checks that make each wrapper raise on what its kernel does not take
(`check_layout`, which `_check` runs before every launch).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as k2
from repro_torch.kernels.flash_decode import ops as k4


@pytest.mark.parametrize("D,want", [
    (8, (64, 128)), (24, (64, 128)), (64, (64, 128)), (72, (128, 128)),
    (112, (128, 128)), (128, (128, 128)), (136, (192, 64)), (192, (192, 64)),
    (200, (256, 64)), (256, (256, 64)),
])
def test_k2_tile_config_per_head_dim(D, want):
    dp, bk = k2.tile_config(D)
    assert (dp, bk) == want
    assert dp % 64 == 0 and D <= dp < D + 64  # whole 128-byte rows, least padding


@pytest.mark.parametrize("D", [0, 264])
def test_k2_tile_config_raises_outside_the_kernel(D):
    with pytest.raises(ValueError):
        k2.tile_config(D)


def test_k2_tile_config_fits_shared_memory():
    """Q (128 rows) and a 2-stage ring of K and V tiles, with the 1 KB
    alignment slack and the barriers, fit one block's 227 KB."""
    for D in range(8, 257, 8):
        dp, bk = k2.tile_config(D)
        assert 128 * dp * 2 + 2 * 2 * bk * dp * 2 + 1024 + 56 <= 232448


def _k2_tensors(B=1, S=16, Hq=2, Hkv=1, D=32, dtype=torch.bfloat16):
    return [torch.zeros(B, S, h, D, dtype=dtype) for h in (Hq, Hkv, Hkv)]


def test_k2_check_layout_takes_what_the_kernel_takes():
    k2.check_layout(*_k2_tensors(), 0)
    k2.check_layout(*_k2_tensors(D=24, Hq=8, Hkv=2), 100)
    qkv = torch.zeros(2, 33, 3, 4, 112, dtype=torch.bfloat16)  # a fused projection
    k2.check_layout(*qkv.unbind(2), 0)
    # cross attention: Sq != Sk (whisper's 448 queries over 1500 frames)
    q, _, _ = _k2_tensors(S=448, Hq=6, Hkv=6, D=64)
    _, k, v = _k2_tensors(S=1500, Hq=6, Hkv=6, D=64)
    k2.check_layout(q, k, v, 0)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "D", "D_odd", "G", "stride",
                                 "window", "ndim"])
def test_k2_check_layout_raises(bad):
    q, k, v = _k2_tensors()
    window = 0
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "mixed":
        k = k.float()
    elif bad == "D":
        q, k, v = _k2_tensors(D=264)
    elif bad == "D_odd":
        q, k, v = _k2_tensors(D=36)
    elif bad == "G":
        q, k, v = _k2_tensors(Hq=3, Hkv=2)
    elif bad == "stride":  # a row stride of 33 elements: not 16-byte aligned
        k = torch.zeros(1, 16, 1, 33, dtype=torch.bfloat16)[..., 1:]
        q, v = _k2_tensors(D=32)[0], k.clone()
    elif bad == "window":
        window = -1
    elif bad == "ndim":
        q = q[0]
    with pytest.raises(ValueError):
        k2.check_layout(q, k, v, window)


@pytest.mark.parametrize("cap,splits", [(1, 1), (64, 1), (65, 2), (320, 5),
                                        (512, 8), (4096, 64), (4097, 65)])
def test_k4_split_plan(cap, splits):
    B, Hkv, G, D = 4, 8, 2, 256
    plan = k4.split_plan(B, Hkv, cap, G, D)
    assert plan["splits"] == splits == -(-cap // k4.SPLIT_ROWS)
    assert plan["partials"] == (B, Hkv, splits, G, D + 2)
    assert plan["counters"] == (B * Hkv,)


def test_k4_split_plan_depends_on_the_buffer_only():
    """The plan is a function of shapes: kv_valid never enters it (it is on
    the card, and reading it would stall decode)."""
    assert k4.split_plan(8, 8, 4096, 2, 256)["splits"] == 64
    assert k4.split_plan(3, 2, 200, 8, 96) == {
        "splits": 4, "partials": (3, 2, 4, 8, 98), "counters": (6,)}


def _k4_tensors(B=2, cap=64, Hq=4, Hkv=2, D=32, dtype=torch.bfloat16):
    q = torch.zeros(B, 1, Hq, D, dtype=dtype)
    k, v = (torch.zeros(B, cap, Hkv, D, dtype=dtype) for _ in range(2))
    rows = torch.ones(B, dtype=torch.int32)
    return q, k, v, rows, rows.clone()


def test_k4_check_layout_takes_what_the_kernel_takes():
    """Whole caches, and two slots' view of a pool (strided rows)."""
    k4.check_layout(*_k4_tensors(), 0)
    q, k, v, kvv, qo = _k4_tensors(B=4, cap=320, Hq=16, Hkv=8, D=256)
    k4.check_layout(q[1:3].contiguous(), k[1:3], v[1:3], kvv[1:3].contiguous(),
                    qo[1:3].contiguous(), 1024)


@pytest.mark.parametrize("bad", ["dtype", "G", "D", "q_noncontig", "kv_strides",
                                 "align", "kv_valid_dtype", "kv_valid_shape",
                                 "window", "q_len"])
def test_k4_check_layout_raises(bad):
    q, k, v, kvv, qo = _k4_tensors()
    window = 0
    if bad == "dtype":
        k = k.float()
    elif bad == "G":
        q, k, v, kvv, qo = _k4_tensors(Hq=6, Hkv=2)
    elif bad == "D":
        q, k, v, kvv, qo = _k4_tensors(D=264)
    elif bad == "q_noncontig":
        q = torch.zeros(2, 1, 32, 4, dtype=torch.bfloat16).transpose(2, 3)
    elif bad == "kv_strides":
        v = v.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "align":
        k, v = (torch.zeros(2, 64, 2, 33, dtype=torch.bfloat16)[..., 1:]
                for _ in range(2))
    elif bad == "kv_valid_dtype":
        kvv = kvv.long()
    elif bad == "kv_valid_shape":
        kvv = kvv[:1]
    elif bad == "window":
        window = -1
    elif bad == "q_len":
        q = torch.zeros(2, 2, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k4.check_layout(q, k, v, kvv, qo, window)
