"""The port's MoE serving path on qwen3-moe-30b-a3b's smoke config (no
shared experts) against the JAX reference, in f32; the checks live in
tests/torch_moe_serving.py: the `moe` block's prefill, decode and extend
within 1e-5 of the reference's; greedy tokens of the port's two engines
equal to the reference's sequential and continuous engines'. (Prefill +
decode against the forward: tests/test_torch_decode_consistency.py.)
"""
import torch_moe_serving as MS

ARCH = "qwen3-moe-30b-a3b"


def test_moe_block_serving_matches_reference():
    MS.check_block_serving(ARCH)


def test_greedy_parity_with_reference():
    MS.check_greedy_parity(ARCH)
