"""The client axis across ranks on the card. Marked `cuda`: they skip
without a card. The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_mesh_cuda.py

  * Two ranks share cuda:0 over gloo (NCCL refuses two ranks on one card)
    and run one mtsl round of paper-mlp (M = 4) on data=2: the loss and
    every state leaf within 1e-5 of the unsharded round on the card, and
    each rank's update is one K1 launch.
  * A world of one rank over NCCL (data=1): the sharded round is the
    unsharded one bit for bit (an all-reduce over one rank returns its
    input).
"""
import numpy as np
import pytest
import torch

from torch_mesh_ranks import max_gap, spawn

P = {"M": 4, "lr": 0.1}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks' rounds and K1 run on the card")


def _payload():
    rng = np.random.default_rng(0)
    return {**P, "batch": {
        "image": rng.normal(size=(P["M"], 16, 8, 8)).astype(np.float32),
        "label": rng.integers(0, 10, size=(P["M"], 16)).astype(np.int32)}}


def _run(world, backend, tmp):
    send, join = spawn(world, "card", tmp, backend=backend)
    send(_payload())
    return join()


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(tmp_path):
    _need_card()
    out = _run(2, "gloo", tmp_path)
    (d_loss, d_state), (loss, state) = out["dense"], out["mesh"]
    assert abs(loss - d_loss) <= 1e-5 * max(1.0, abs(d_loss))
    assert max_gap(state, d_state) <= 1e-5


@pytest.mark.cuda
def test_world_of_one_over_nccl_is_bit_equal(tmp_path):
    _need_card()
    out = _run(1, "nccl", tmp_path)
    (d_loss, d_state), (loss, state) = out["dense"], out["mesh"]
    assert loss == d_loss
    assert max_gap(state, d_state) == 0.0
