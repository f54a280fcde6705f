"""The port's serving path of zamba2-7b's smoke config (hybrid: Mamba
blocks and the stack's shared attention block, with its own KV cache per
application) against the JAX reference, in f32; the checks live in
tests/torch_ssm_serving.py:

  * prefill + step-by-step decode reproduce the teacher-forced forward's
    logits within 3e-5 (the twin of tests/test_decode_consistency.py);
  * the reference's continuous-batching scenario (3 slots, 5 mixed-length
    requests, chunk 4, M = 2): greedy tokens of the port's ContinuousEngine
    and generate_sequential equal the reference's generate_sequential token
    for token, and the prefill logits agree within 1e-4;
  * after the continuous engine has decoded slots of both clients, each
    slot's conv tails and SSM state equal the sequential engine's.

The Mamba block's own serving functions are held against the reference's
in tests/test_torch_ssm_serving.py (the two smoke configs give the block
the same shapes).
"""
import torch_ssm_serving as S

ARCH = "zamba2-7b"


def test_prefill_decode_matches_forward():
    S.check_prefill_decode_matches_forward(ARCH)


def test_greedy_parity_with_reference():
    S.check_greedy_parity(ARCH)


def test_decode_freezes_other_clients_rows():
    S.check_decode_freezes_other_rows(ARCH)
