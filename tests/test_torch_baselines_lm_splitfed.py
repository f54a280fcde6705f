"""splitfed on the decoder LMs against the JAX reference: the smoke configs
of mamba2-130m (ssm) and zamba2-7b (hybrid: Mamba2 layers and the
stack-level shared attention block), their own M, local_steps 2, SGD lr
0.05 (the LM chip phases' rate), 2 sequences of 24 tokens a step, 3 rounds
under a drawn masked schedule (participation 0.5). The towers loop over
clients in Python (attention and SSD scan run their kernels' plain
versions here) and each local step goes through K1's plain version.
Tolerance: losses, per-task losses, every parameter leaf and the eval's
per-task losses within 1e-5.

At the classifier cells' lr 0.1 only the losses are held (the last test):
over those 6 steps zamba2's tower embedding drifts from the reference's by
2.7e-7, 1.6e-6, 1.3e-5 after rounds 1-3 (8 of 131,072 elements past
1e-5). That is f32 rounding amplified by the trajectory, not a fault of
the port: the reference's own f32 run is 2.0e-5 away from the port's run
with f64 parameters, the port's f32 run 2.7e-5; the accepted mtsl round
passes 1e-5 after 7 steps the same way (1.1e-5; tests/test_torch_lm_round.py
holds 3). At lr 0.05 the largest gap of the four LM cases is 1.6e-6.
tests/torch_baseline_drift.py prints these numbers."""
import pytest

from repro_torch.configs import get_config
from torch_baseline_parity import SCHEDULES, one_thread, run_parity  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SCHEDULES.setdefault("lm-masked", {"participation_rate": 0.5, "seed": 3})


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_lm_splitfed_round_matches_jax(arch):
    cfg = get_config(arch, smoke=True)
    run_parity(arch, "splitfed", "lm-masked", M=cfg.num_clients, width=2, lr=0.05)


def test_lm_splitfed_losses_match_jax_at_lr_0_1():
    cfg = get_config("zamba2-7b", smoke=True)
    run_parity("zamba2-7b", "splitfed", "lm-masked", M=cfg.num_clients,
               width=2, lr=0.1, hold_params=False)
