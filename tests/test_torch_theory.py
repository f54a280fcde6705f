"""The port's `core/theory.py` (a numpy copy) and `optim/schedules.py`
against the reference's: the five theory cases of
tests/test_theory_and_data.py, each on the same trajectories from both
packages (bit-equal: the same numpy code), and the schedule checks of
tests/test_substrate.py, each value within 1e-6 of the reference's."""
import numpy as np
import pytest

from repro.core import theory as ref_theory
from repro.optim import schedules as ref_schedules
from repro_torch.core import theory
from repro_torch.optim import constant, cosine, inverse_sqrt, warmup_cosine

P0 = {"w": 0.1, "d": 0.0, "b": [0.1, 0.1], "a": [0.0, 0.0]}


def _both(run, **setup):
    """run(system) from the port's and the reference's setup: equal arrays."""
    got = run(theory.paper_fig2_setup(**setup))
    want = run(ref_theory.paper_fig2_setup(**setup))
    np.testing.assert_array_equal(got, want)
    return got


def test_gd_descends_with_lipschitz_lr():
    traj = _both(lambda s: s.run_gd(P0, 0.1, np.full(2, 0.1), steps=400,
                                    adaptive=True))
    total = traj.sum(axis=1)
    assert np.all(np.diff(total) <= 1e-9)
    assert total[-1] < total[0] * 1e-3


def test_high_moment_client_has_tighter_lr_range():
    with np.errstate(over="ignore", invalid="ignore"):
        diverge2 = _both(lambda s: s.run_gd(P0, 0.002, [0.01, 0.5], steps=300),
                         moment_ratio=10.0)
    assert np.isnan(diverge2).any() or diverge2[-1].sum() > 1e3
    ok1 = _both(lambda s: s.run_gd(P0, 0.002, [0.5, 0.01], steps=300),
                moment_ratio=10.0)
    assert np.isfinite(ok1).all() and ok1[-1].sum() < 1.0


def test_lr_tuning_speeds_up_low_moment_client():
    base = _both(lambda s: s.run_gd(P0, 0.002, [0.01, 0.01], steps=100))
    fast1 = _both(lambda s: s.run_gd(P0, 0.002, [0.02, 0.01], steps=100))
    assert fast1[-1, 0] < base[-1, 0]
    assert np.isfinite(fast1).all()


def test_convergence_rate_order_1_over_T():
    traj = _both(lambda s: s.run_gd(P0, 0.1, np.full(2, 0.1), steps=800,
                                    adaptive=True), moment_ratio=2.0).sum(axis=1)
    for T in (100, 200, 400, 800):
        assert traj[T] <= traj[50] * 50 / T * 3.0


def test_mtsl_shared_server_helps_lagging_task():
    sep = _both(lambda s: s.run_separate(P0, 0.01, steps=100))
    shared = _both(lambda s: s.run_gd(P0, 0.01, [0.01, 0.01], steps=100))
    assert shared[100, 1] < sep[100, 1]
    # the Lipschitz constants the lr policy reads agree too
    p = {k: np.asarray(v, float) for k, v in P0.items()}
    got = theory.paper_fig2_setup().lipschitz(p)
    want = ref_theory.paper_fig2_setup().lipschitz(p)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


SCHEDULES = [
    ("constant", (0.1,), 0.1, 0.1),
    ("cosine", (1.0, 100), 0.1, 1.0),
    ("warmup_cosine", (1.0, 10, 100), 0.0, 1.0),
    ("inverse_sqrt", (1.0, 10), 0.0, 1.0),
]


@pytest.mark.parametrize("name,args,lo,hi", SCHEDULES)
def test_schedules_shapes_and_bounds(name, args, lo, hi):
    port = {"constant": constant, "cosine": cosine, "warmup_cosine": warmup_cosine,
            "inverse_sqrt": inverse_sqrt}[name](*args)
    ref = getattr(ref_schedules, name)(*args)
    vals = [float(port(s)) for s in range(0, 120, 10)]
    assert all(lo - 1e-6 <= v <= hi + 1e-6 for v in vals), vals
    for s in range(0, 120, 5):
        assert abs(float(port(s)) - float(ref(s))) <= 1e-6, (name, s)


def test_warmup_cosine_monotone_warmup():
    fn, ref = warmup_cosine(1.0, 20, 100), ref_schedules.warmup_cosine(1.0, 20, 100)
    v = [float(fn(s)) for s in range(20)]
    assert all(b >= a for a, b in zip(v, v[1:]))
    assert abs(float(fn(20)) - 1.0) < 0.05
    for s in range(0, 40):
        assert abs(float(fn(s)) - float(ref(s))) <= 1e-6
