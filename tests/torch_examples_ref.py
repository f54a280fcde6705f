"""What tests/test_torch_examples*.py share: the example twins imported
from examples/, the reference harness, the reference's inits converted
to the port's states, and the comparison of two runs.

The runs are single-threaded (torch's CPU thread pool costs these small
models several times their compute).
"""
import functools
import importlib
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

from benchmarks import common as bench  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import algorithms as jax_alg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.utils.convert import state_from_jax  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin(name):
    return importlib.import_module(f"torch_{name}")


@functools.lru_cache(maxsize=None)
def reference_custom():
    """The reference example's module (registers "local" there)."""
    spec = importlib.util.spec_from_file_location("_ref_custom_algorithm",
                                                  ROOT / "examples" / "custom_algorithm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def init_fn(arch, smoke, local_steps, seed=0):
    """alg -> the port's state converted from run_algorithm's init."""
    def init(alg):
        cfg = jax_get_config(arch, smoke=smoke)
        a = jax_alg.get_algorithm(alg)
        hp = jax_alg.HParams(lr=0.1, local_steps=local_steps)
        st = jax.tree.map(np.asarray, a.init_state(jax_build_model(cfg), jax.random.PRNGKey(seed),
                                                  cfg.num_clients, hp))
        return state_from_jax("fedavg" if alg == "local" else alg, st, "cpu",
                              get_config(arch, smoke=smoke))
    return init


def same(got, want, what):
    assert abs(got.acc_mtl - want.acc_mtl) <= TOL, (what, got.acc_mtl, want.acc_mtl)
    assert got.total_bytes == want.total_bytes, what
    assert got.bytes_to_acc == want.bytes_to_acc, what
    assert got.mean_participants == want.mean_participants, what
    assert got.sim_to_acc == want.sim_to_acc, what
    assert got.total_sim_s == want.total_sim_s, what
    assert len(got.acc_curve) == len(want.acc_curve), what
