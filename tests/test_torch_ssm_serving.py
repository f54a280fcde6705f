"""The port's serving path of mamba2-130m's smoke config (ssm: every layer
a Mamba block) against the JAX reference, in f32; the checks live in
tests/torch_ssm_serving.py:

  * the Mamba block's serving functions (prefill, decode, extend with
    padded rows and a nonzero state, the forward from an initial state)
    hold within 1e-5 of the reference's, on the outputs and on every cache
    leaf; decode honours `write`;
  * prefill + step-by-step decode reproduce the teacher-forced forward's
    logits within 3e-5 (the twin of tests/test_decode_consistency.py);
  * the reference's continuous-batching scenario (3 slots, 5 mixed-length
    requests, chunk 4, M = 2): greedy tokens of the port's ContinuousEngine
    and generate_sequential equal the reference's generate_sequential token
    for token, and the prefill logits agree within 1e-4;
  * after the continuous engine has decoded slots of both clients, each
    slot's conv tails and SSM state equal the sequential engine's.
"""
import pytest

import torch_ssm_serving as S

ARCH = "mamba2-130m"


def test_mamba_prefill_matches_reference():
    S.check_block_prefill(ARCH)


def test_mamba_decode_matches_reference_and_honours_write():
    S.check_block_decode(ARCH)


@pytest.mark.parametrize("C", [4, 5, 16])
def test_mamba_extend_matches_reference(C):
    S.check_block_extend(ARCH, C)


def test_prefill_decode_matches_forward():
    S.check_prefill_decode_matches_forward(ARCH)


def test_greedy_parity_with_reference():
    S.check_greedy_parity(ARCH)


def test_decode_freezes_other_clients_rows():
    S.check_decode_freezes_other_rows(ARCH)
