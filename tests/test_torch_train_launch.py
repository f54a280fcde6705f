"""The port's training launcher against the reference's, with the same
argv: `repro.launch.train.main([... --prefetch 0])` and
`repro_torch.launch.train.main([... --device cpu])`. The reference
initialises its state with jax.random, which torch cannot reproduce, so
both registries' mtsl `init_state` are swapped for ones that return one
initial tree: the reference's `PRNGKey(seed)` draw (jitted: one compile
instead of one per eager op), carried across with `params_from_jax`. Batches and schedules are drawn by each package
from the same seeds (byte-identical, tests/test_torch_data_schedule.py).
The histories must agree entry for entry: step, round and participants
exactly, the loss within 1e-5 (f32, reduction order)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.launch.train import main as jax_main
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core.mtsl import TrainState
from repro_torch.launch.train import main
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_map

ARGVS = {
    "mlp": ["--arch", "paper-mlp", "--smoke", "--steps", "4"],
    "resnet-masked": ["--arch", "paper-resnet16", "--smoke", "--steps", "4",
                      "--participation-rate", "0.5", "--batch-per-client", "4"],
    "mlp-capability-microbatches": [
        "--arch", "paper-mlp", "--smoke", "--steps", "4", "--capability-batching",
        "--straggler-frac", "0.5", "--hp", "microbatches=2", "--batch-per-client", "4"],
    "mlp-adamw": ["--arch", "paper-mlp", "--smoke", "--steps", "4",
                  "--optimizer", "adamw", "--lr", "0.01", "--seed", "2"],
}


_JAX_INIT = jax_alg.get_algorithm("mtsl").init_state


def _reference_init(arch, seed, hp):
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    return jax.jit(lambda rng: _JAX_INIT(model, rng, cfg.num_clients, hp))(
        jax.random.PRNGKey(seed))


@pytest.mark.parametrize("name", list(ARGVS))
def test_port_launcher_matches_reference(name, monkeypatch):
    argv = ARGVS[name]
    arch = argv[argv.index("--arch") + 1]
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    jax_alg_mtsl = jax_alg.get_algorithm("mtsl")

    def jax_init(model, rng, num_clients, hp):
        return _reference_init(arch, seed, hp)

    def port_init(model, gen, num_clients, hp):
        state_j = _reference_init(arch, seed, jax_alg.HParams())
        p = params_from_jax(jax.tree.map(np.asarray, state_j.params), "cpu",
                            get_config(arch, smoke=True))
        p = tree_map(lambda x: x.requires_grad_(), p)
        return TrainState(p, alg_mod._mtsl_optimizer(hp).init(p), 0)

    monkeypatch.setitem(jax_alg._REGISTRY, "mtsl",
                        dataclasses.replace(jax_alg_mtsl, init_state=jax_init))
    monkeypatch.setitem(alg_mod._REGISTRY, "mtsl", dataclasses.replace(
        alg_mod.get_algorithm("mtsl"), init_state=port_init))
    _, hist_j = jax_main(argv + ["--prefetch", "0"])
    _, hist = main(argv + ["--device", "cpu"])
    assert len(hist) == len(hist_j) >= 2
    for a, b in zip(hist, hist_j):
        for k in ("step", "round", "participants"):
            assert a[k] == b[k]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, atol=1e-5)


def test_train_eval_cadence_matches_reference():
    """`train()` with eval batches: the same history entries as the
    reference's loop (first round, every eval_every-th round, and the final
    round, which always evals), acc_mtl equal, losses within 1e-5."""
    from repro.core.schedule import ScheduleConfig as JaxScheduleConfig
    from repro.data.pipeline import client_batches as jax_client_batches
    from repro.data.synthetic import MultiTaskImageSource as JaxSource
    from repro.optim import sgd as jax_sgd
    from repro.train.loop import TrainConfig as JaxTrainConfig
    from repro.train.loop import train as jax_train
    from repro_torch.core.schedule import ScheduleConfig
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train

    arch, M, b = "paper-resnet16", 3, 4
    cfg = get_config(arch, smoke=True)
    state_j = _reference_init(arch, 0, jax_alg.HParams())
    kw = dict(num_classes=M, image_size=cfg.image_size, channels=cfg.image_channels)
    evals = [next(client_batches(MultiTaskImageSource(**kw, seed=9), 6, seed=9))]
    common = dict(steps=5, log_every=0, eval_every=2)
    _, hist_j = jax_train(
        jax_build_model(jax_get_config(arch, smoke=True)), jax_sgd(0.1),
        jax_client_batches(JaxSource(**kw), b, steps=5, as_numpy=True),
        JaxTrainConfig(**common, prefetch=0,
                       schedule=JaxScheduleConfig(participation_rate=0.6, seed=1)),
        M, eval_batches=evals, log=lambda _: None, init_state=state_j)
    params = tree_map(lambda x: x.requires_grad_(), params_from_jax(
        jax.tree.map(np.asarray, state_j.params), "cpu", cfg))
    _, hist = train(
        build_model(cfg), sgd(0.1), client_batches(MultiTaskImageSource(**kw), b),
        TrainConfig(**common, device="cpu",
                    schedule=ScheduleConfig(participation_rate=0.6, seed=1)),
        M, eval_batches=evals, log=lambda _: None,
        init_state=TrainState(params, (), 0))
    assert [e["round"] for e in hist] == [e["round"] for e in hist_j] == [1, 2, 4, 5]
    for a, r in zip(hist, hist_j):
        assert a["participants"] == r["participants"]
        assert ("acc_mtl" in a) == ("acc_mtl" in r)
        if "acc_mtl" in a:
            assert a["acc_mtl"] == r["acc_mtl"]
        np.testing.assert_allclose(a["loss"], r["loss"], rtol=1e-5, atol=1e-5)
