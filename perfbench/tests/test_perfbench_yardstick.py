"""The frozen cost models, peaks and model-FLOPs formulas against values
worked out by hand."""
import pytest

from perfbench.tests import smoke  # noqa: F401  (puts the repo on sys.path)
from perfbench.lib import readers
from perfbench.yardstick import costs, flops, peaks

HYBRID = {"family": "hybrid", "num_layers": 2, "d_model": 4, "vocab_size": 10,
          "num_heads": 1, "num_kv_heads": 1, "head_dim": 4, "d_ff": 8,
          "ssm_expand": 2, "ssm_headdim": 4, "ssm_state": 2, "ssm_conv_width": 2,
          "shared_attn_every": 2, "split_layers": 1}
MOE = {"family": "moe", "num_layers": 2, "d_model": 4, "vocab_size": 10,
       "num_heads": 1, "num_kv_heads": 1, "head_dim": 4, "d_ff": 8, "num_experts": 4,
       "experts_per_token": 2, "num_shared_experts": 1, "moe_d_ff": 2,
       "first_dense_layers": 1, "split_layers": 1}


def test_kernel_costs_by_hand():
    assert costs.update_cost(1000, 4) == (2000, 12000)
    # 10 visible pairs (causal, S 4); q, out 1x4x2x8, k, v 1x4x1x8 in bf16
    assert costs.attention_cost(1, 4, 4, 2, 1, 8, True, 0, 2) == (640, 384)
    assert costs.visible_pairs(6, 6, True, 2) == 3 + 4 * 2
    assert costs.scan_cost(1, 8, 2, 4, 2, 4, 2, False) == (1024, 456)


def test_peaks():
    assert peaks.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 1.0, "float32") == pytest.approx(1.0)


def test_model_flops_by_hand():
    # weights a token passes: head 40, two Mamba layers 120 each, the shared
    # block's attention 64 and MLP 96; attention 4 H D a visible pair; the
    # SSD 4 P N H + conv 2 W (d_in + 2 N) a token a layer
    assert flops.forward_flops(HYBRID, 3, 6) == 2 * 440 * 3 + 96 + 2 * 112 * 3
    assert flops.train_round_flops(HYBRID, 1, 1, 3) == 3 * 3408
    # the dense lead 160, the MoE layer 64 + router 16 + 3 experts x 24
    assert flops.forward_flops(MOE, 2, 3) == 2 * (40 + 160 + 152) * 2 + 4 * 4 * 2 * 3


def test_roofline_mix():
    calls = [(2, 1.0), (1, 4.0)]  # mean bound 2.0 a call
    assert readers.roofline_pct(calls, 3, 12.0) == pytest.approx(50.0)
    assert readers.roofline_pct(calls, 0, 1.0) is None
    assert readers.is_matmul("nvjet_hsh_128x256_64x4") and readers.is_matmul("sm90_xmma_gemm")
    assert not readers.is_matmul("ssd_scan_tc_kernel")
