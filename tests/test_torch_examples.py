"""The port's example twins (examples/torch_*.py) at a cut --steps on the
CPU against the reference's runs with the same arguments
(`benchmarks.common.run_algorithm`; for add_new_client, the reference
example's own two phases), each port run from the reference's init:
Accuracy_MTL within 1e-5, and the bytes, bytes to each threshold, mean
participants and simulated seconds equal (tests/torch_examples_ref.py).
This file: quickstart, custom_algorithm ("local" registers in the port's
registry as in the reference's) and add_new_client; the schedule and
topology tours are tests/test_torch_examples_tours.py's.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.algorithms import get_algorithm, list_algorithms
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_map
from torch_examples_ref import TOL, bench, init_fn, one_thread, reference_custom, same, twin

import torch

pytestmark = pytest.mark.usefixtures("one_thread")
_ = one_thread


def test_quickstart_matches_reference():
    f = 0.005
    got = twin("quickstart").main(["--device", "cpu", "--steps", str(f)],
                                  init=init_fn("paper-mlp", False, 100))
    for alg, steps in (("fedavg", 2000), ("mtsl", 400)):
        want = bench.run_algorithm("paper-mlp", alg, alpha=0.0,
                                   steps=round(steps * f), lr=0.1, local_steps=100)
        same(got[alg], want, alg)


def test_custom_algorithm_registers_and_matches_reference():
    reference_custom()
    mod = twin("custom_algorithm")
    assert "local" in list_algorithms()
    a = get_algorithm("local")
    assert a.phases is None and a.round_bytes(None, 3, 8, None) == 0
    state = {"towers": {"w": torch.zeros(3, 2)}, "servers": {"w": torch.zeros(3, 2)}}
    marks = a.client_axes(state)
    assert marks["towers"]["w"] and marks["servers"]["w"]
    f = 0.01
    got = mod.main(["--device", "cpu", "--steps", str(f)],
                    init=init_fn("paper-mlp", False, 100))
    for alg in ("local", "mtsl"):
        want = bench.run_algorithm("paper-mlp", alg, alpha=0.0, steps=round(400 * f),
                                   lr=0.1, local_steps=100)
        same(got[alg], want, alg)


def _reference_new_client(f):
    """The reference example's two phases at a fraction f of its steps."""
    import jax.numpy as jnp

    from repro.core import lr_policy
    from repro.core.mtsl import TrainState, build_eval_step, build_train_step, init_state
    from repro.core.split import client_freeze_lr
    from repro.data.pipeline import client_batches
    from repro.optim import sgd
    from repro.utils.sharding import strip

    cfg = jax_get_config("paper-mlp")
    model = jax_build_model(cfg)
    M = cfg.num_clients
    new = M - 1
    src = bench.make_source(cfg, alpha=0.0)
    tb = bench.test_batches(cfg, src)
    opt = sgd(0.1)
    params = strip(init_state(model, opt, jax.random.PRNGKey(0), M, "mtsl"))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step_fn = jax.jit(build_train_step(model, opt, M, "mtsl"))
    ev = jax.jit(build_eval_step(model, M))
    clr1 = lr_policy.server_scaled(M, 2.0 / M)
    for batch in client_batches(src, 16, steps=round(400 * f), seed=1):
        for k in batch:
            batch[k] = batch[k].at[new].set(batch[k][0])
        state, _ = step_fn(state, batch, clr1)
    acc1 = np.asarray(ev(state.params, tb)["per_task_acc"])
    clr2 = client_freeze_lr(M, new)
    for batch in client_batches(src, 16, steps=round(200 * f), seed=2):
        state, _ = step_fn(state, batch, clr2)
    acc2 = np.asarray(ev(state.params, tb)["per_task_acc"])
    return jax.tree.map(np.asarray, params), acc1, acc2


def test_add_new_client_matches_reference():
    f = 0.02
    params, acc1, acc2 = _reference_new_client(f)
    cfg = get_config("paper-mlp")
    init = tree_map(lambda x: x.requires_grad_(), params_from_jax(params, "cpu", cfg))
    got = twin("add_new_client").main(["--device", "cpu", "--steps", str(f)], init=init)
    np.testing.assert_allclose(got["acc1"], acc1, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["acc2"], acc2, atol=TOL, rtol=0)
    assert got["server_moved"] == 0.0  # phase 2 trains the new tower only
