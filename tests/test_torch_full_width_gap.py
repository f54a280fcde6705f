"""The port's mtsl round against the JAX reference's at full width: full
paper-resnet16 (M = 10, b = 8), 3 rounds under participation 0.5, from one
initial tree (drawn in JAX, carried across) and the same batches, on the
CPU in f32.

At lr 0.01 every parameter stays within 1e-5 of the reference's (the test).
At the train slice's lr 0.1 the two f32 implementations drift further
apart from the second round on: the gradients' rounding noise alone moves
the parameters by more than 1e-5 there, even from identical parameters.
Run as a script, the file prints the gap per round at both rates:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_full_width_gap.py
"""
import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import lr_policy as jax_lr_policy
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import lr_policy, schedule
from repro_torch.core.mtsl import TrainState
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

ARCH, M, B, ROUNDS = "paper-resnet16", 10, 8, 3


def round_gaps(lr: float) -> list:
    """Per round: (reference loss, port loss, max |param gap|, its leaf)."""
    cfg_j = jax_get_config(ARCH)
    model_j = jax_build_model(cfg_j)
    alg_j = jax_alg.get_algorithm("mtsl")
    state_j = jax.jit(lambda r: alg_j.init_state(model_j, r, M, jax_alg.HParams(lr=lr)))(
        jax.random.PRNGKey(3))
    cfg = get_config(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, state_j.params), "cpu", cfg)
    state = TrainState(tree_map(lambda x: x.requires_grad_(), params), (), 0)
    rf_j = jax_alg.jit_round_fn(alg_j, model_j, M, jax_alg.HParams(
        lr=lr, component_lr=jax_lr_policy.server_scaled(M)))
    rf = alg_mod.get_algorithm("mtsl").round_fn(build_model(cfg), M, alg_mod.HParams(
        lr=lr, component_lr=lr_policy.server_scaled(M)))
    skw = dict(participation_rate=0.5, seed=3)
    stream_j = jax_schedule.schedule_stream(jax_schedule.ScheduleConfig(**skw), M, 1)
    stream = schedule.schedule_stream(schedule.ScheduleConfig(**skw), M, 1)
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=3)
    out = []
    for batch in client_batches(src, B, steps=ROUNDS, seed=3):
        state_j, met_j = rf_j(state_j, batch, next(stream_j))
        state, met = rf(state, stage_batch(batch, "cpu"), next(stream))
        ref = flatten_dict(state_j.params)
        gap, leaf = max((float(np.abs(p.detach().numpy() - np.asarray(ref[k])).max()), k)
                        for k, p in tree_leaves_with_path(state.params))
        out.append((float(met_j["loss"]), float(met["loss"]), gap, leaf))
    return out


def test_full_width_rounds_within_1e5_at_lr_001():
    for loss_j, loss, gap, leaf in round_gaps(0.01):
        np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
        assert gap <= 1e-5, (gap, leaf)


if __name__ == "__main__":
    for lr in (0.01, 0.1):
        for r, (loss_j, loss, gap, leaf) in enumerate(round_gaps(lr), 1):
            print(f"lr {lr} round {r}: loss jax {loss_j!r} port {loss!r}  "
                  f"max |param gap| {gap!r} ({leaf})")
