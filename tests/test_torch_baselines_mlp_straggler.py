"""The port's six federated baselines against the JAX reference on smoke
paper-mlp (M = 8, local_steps 2, lr 0.1, 8 samples a step, 3 rounds) under
the drawn "straggler" schedule stream of tests/torch_baseline_parity.py
(straggler: participation 0.75 with budget-1 stragglers among the
participants, whose K1 step size is 0 past their budget; capability:
capability batching with stragglers and sample-weighted federation means).
Tolerance as in tests/test_torch_baselines_mlp.py."""
import pytest

from torch_baseline_parity import BASELINES, run_parity


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_round_matches_jax(name):
    run_parity("paper-mlp", name, "straggler", M=8, width=8)
