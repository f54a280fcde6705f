"""The port's six federated baselines against the JAX reference on smoke
paper-mlp, the reference's own cells (tests/test_sharding_parity.py): M = 8,
local_steps 2, lr 0.1, 8 samples a step, 3 rounds under the full schedule
and the masked one (every other client out, with budget 1). Every local
step's update goes through K1's plain version here. Tolerance: losses,
per-task losses and every state leaf within 1e-5 (f32, reduction order);
ParallelSFL's cluster map and the final eval's accuracies equal. See
tests/torch_baseline_parity.py."""
import pytest

from torch_baseline_parity import BASELINES, run_parity


@pytest.mark.parametrize("sched", ["full", "masked"])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_round_matches_jax(name, sched):
    run_parity("paper-mlp", name, sched, M=8, width=8)
