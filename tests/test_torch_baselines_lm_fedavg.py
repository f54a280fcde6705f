"""fedavg on the decoder LMs against the JAX reference: per-client full
models of smoke mamba2-130m and smoke zamba2-7b, looped over in Python,
local_steps 2, SGD lr 0.05, 2 sequences of 24 tokens a step, 3 rounds
under a drawn masked schedule (participation 0.5); every local step through
K1's plain version. Tolerance: losses, per-task losses and every parameter
leaf within 1e-5 (the reference's fedavg eval reads class labels, which an
LM batch has not, so there is no eval to compare). Why lr 0.05: see
tests/test_torch_baselines_lm_splitfed.py."""
import pytest

from repro_torch.configs import get_config
from torch_baseline_parity import SCHEDULES, one_thread, run_parity  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SCHEDULES.setdefault("lm-masked", {"participation_rate": 0.5, "seed": 3})


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_lm_fedavg_round_matches_jax(arch):
    cfg = get_config(arch, smoke=True)
    run_parity(arch, "fedavg", "lm-masked", M=cfg.num_clients, width=2, lr=0.05)
