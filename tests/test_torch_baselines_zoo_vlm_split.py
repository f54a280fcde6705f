"""The split baselines (splitfed, smofi, parallelsfl) on
llama-3.2-vision-11b against the JAX reference: the VLM (cross-attention
layers over projected vision features; each batch carries `vis`).
tests/test_torch_baselines_zoo_vlm.py holds the other three.

The smoke config, its own M, local_steps 2, SGD lr 0.05, 2 samples of 24
tokens a step (with the family's extra input drawn from
np.random.default_rng as tests/test_torch_zoo_round.py's `zoo_batches`
draws it), 3 rounds under a drawn masked schedule (participation 0.5), as
the LM baseline files; every local step through K1's plain version and
the attention through K2's. Tolerance: losses, per-task losses and every
state leaf within 1e-5, and the eval within 1e-5 where the reference has
one for the family: the evals that read class labels (fedavg, fedprox,
parallelsfl) and FedEM's, which asserts a classifier, are refused by
both packages (tests/torch_baseline_parity.py)."""
import pytest

from repro_torch.configs import get_config
from torch_baseline_parity import SCHEDULES, one_thread, run_parity  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SCHEDULES.setdefault("lm-masked", {"participation_rate": 0.5, "seed": 3})
ARCH = "llama-3.2-vision-11b"


@pytest.mark.parametrize("name", ["splitfed", "smofi", "parallelsfl"])
def test_vlm_split_baseline_round_matches_jax(name):
    cfg = get_config(ARCH, smoke=True)
    run_parity(ARCH, name, "lm-masked", M=cfg.num_clients, width=2, lr=0.05)
