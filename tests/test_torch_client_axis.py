"""The port's client axis (`repro_torch.core.client_axis`) and its chunked
rounds, against `repro.core.client_axis` / `shard_round_fn(client_chunk=)`.

  * `client_map` under `client_axis(chunk=c)` equals the unchunked map for
    c in 1, 2, 4 and 8; the chunk's validation.
  * The chunked round (`shard_round_fn(..., client_chunk=2)`, each block's
    backward before the next) against the dense round, for fedavg, fedem
    and fedprox x {full, masked} schedules (the masked one with straggler
    budgets): 3 rounds, losses and every state leaf within 1e-5; and
    against the reference's chunked round from the reference's initial
    state, losses within 1e-5 of their scale. The chunked eval equals the
    dense eval. The other four algorithms are in
    tests/test_torch_client_axis_split.py (shared checks:
    tests/torch_client_axis.py).
"""
import pytest
import torch

from repro_torch.core.algorithms import HParams, get_algorithm, shard_round_fn
from repro_torch.core.client_axis import client_axis, client_blocks, client_map
from torch_client_axis import MODEL, check_chunked_round


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
def test_client_map_chunked_matches_unchunked(chunk):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 5, 3, generator=g)
    x = torch.randn(8, 4, 5, generator=g)
    bias = torch.randn(3, generator=g)

    def fn(w_m, x_m, b):
        return {"y": torch.tanh(x_m @ w_m + b), "n": (x_m ** 2).sum()}

    want = client_map(fn, w, x, bias, in_axes=(0, 0, None))
    with client_axis(chunk=chunk):
        got = client_map(fn, w, x, bias, in_axes=(0, 0, None))
        assert len(list(client_blocks(8))) == 8 // chunk
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


def test_client_axis_validation():
    with pytest.raises(ValueError, match=">= 1"):
        with client_axis(chunk=0):
            pass
    with client_axis(chunk=3):
        with pytest.raises(ValueError, match="divisible"):
            list(client_blocks(8))
    with pytest.raises(ValueError, match="divisible"):
        shard_round_fn(get_algorithm("mtsl"), MODEL, 6, HParams(), client_chunk=4)
    with pytest.raises(NotImplementedError):
        shard_round_fn(get_algorithm("mtsl"), MODEL, 4, HParams(), mesh=object())


@pytest.mark.parametrize("alg", ["fedavg", "fedem", "fedprox"])
@pytest.mark.parametrize("sched_name", ["full", "masked"])
def test_chunked_round_matches_dense_and_reference(alg, sched_name):
    check_chunked_round(alg, sched_name)
