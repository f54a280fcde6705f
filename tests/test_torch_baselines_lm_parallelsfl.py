"""parallelsfl on the decoder LMs against the JAX reference: ParallelSFL
(clusters of clients, each against its own server replica; the cluster
map must be equal). The smoke configs of mamba2-130m (ssm) and zamba2-7b
(hybrid), their own M, local_steps 2, SGD lr 0.05, 2 sequences of 24
tokens a step, 3 rounds under a drawn masked schedule (participation
0.5), as tests/test_torch_baselines_lm_splitfed.py; every local step
through K1's plain version, attention and SSD scan through K2's and
K3's. Tolerance: losses, per-task losses and every state leaf within
1e-5, and the eval within 1e-5 where the reference has one for an LM
(the shared checks of tests/torch_baseline_parity.py). Why lr 0.05: see
the splitfed file."""
import pytest

from repro_torch.configs import get_config
from torch_baseline_parity import SCHEDULES, one_thread, run_parity  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SCHEDULES.setdefault("lm-masked", {"participation_rate": 0.5, "seed": 3})


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_lm_parallelsfl_round_matches_jax(arch):
    cfg = get_config(arch, smoke=True)
    run_parity(arch, "parallelsfl", "lm-masked", M=cfg.num_clients, width=2, lr=0.05)
