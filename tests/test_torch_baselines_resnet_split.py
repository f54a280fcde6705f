"""the split baselines (splitfed, smofi, parallelsfl) against the JAX reference on smoke paper-resnet16 (the conv path:
per-client convolutions under vmap, the 1x1 projection as a matmul), M = 8,
local_steps 2, lr 0.1, 4 samples a step, 3 rounds under the reference's
masked cell. Tolerance as in tests/test_torch_baselines_mlp.py."""
import pytest

from torch_baseline_parity import run_parity


@pytest.mark.parametrize("name", ["splitfed", "smofi", "parallelsfl"])
def test_baseline_round_matches_jax(name):
    run_parity("paper-resnet16", name, "masked", M=8, width=4)
