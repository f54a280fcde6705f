"""The port's schedule and topology tours (examples/
torch_simulate_stragglers.py, torch_topology_walltime.py) at a cut
--steps on the CPU against `benchmarks.common.run_algorithm` with the
same arguments, from the reference's init: Accuracy_MTL within 1e-5, and
the bytes, mean participants and simulated seconds equal
(tests/torch_examples_ref.py).
"""
import pytest

from repro.configs import get_config as jax_get_config
from torch_examples_ref import bench, init_fn, one_thread, same, twin

pytestmark = pytest.mark.usefixtures("one_thread")
_ = one_thread


def test_simulate_stragglers_matches_reference():
    from repro.core.schedule import ScheduleConfig

    mod = twin("simulate_stragglers")
    f = 0.5
    got = mod.main(["--device", "cpu", "--steps", str(f)],
                    init=init_fn("paper-mlp", True, 1))
    for label, scfg in mod.REGIMES:
        ref_scfg = ScheduleConfig(**{k: getattr(scfg, k) for k in scfg.__dataclass_fields__})
        want = bench.run_algorithm("paper-mlp", "mtsl", alpha=0.0, steps=round(60 * f),
                                   lr=0.1, smoke=True, eval_every=10, local_steps=1,
                                   batch_per_client=8, schedule=ref_scfg)
        same(got[label.strip()], want, label)


def test_topology_walltime_matches_reference():
    from repro.core import topology as jt

    mod = twin("topology_walltime")
    f = 0.1
    got = mod.main(["--device", "cpu", "--steps", str(f)],
                    init=init_fn("paper-mlp", True, 10))
    M = jax_get_config("paper-mlp", smoke=True).num_clients
    ref_regimes = {
        "ideal links": jt.star(M),
        "slow uplink": jt.star(M, uplink=jt.mbps(2.0, 0.005), downlink=jt.mbps(50.0, 0.005)),
        "slow backbone": jt.clustered(M, 2, uplink=jt.mbps(20.0), downlink=jt.mbps(20.0),
                                      backbone=jt.mbps(1.0, 0.02)),
        "2 synced servers": jt.multi_server(M, 2, uplink=jt.mbps(10.0, 0.002),
                                            downlink=jt.mbps(10.0, 0.002),
                                            backbone=jt.mbps(5.0, 0.01)),
    }
    assert [label.strip() for label, _ in mod.regimes(M)] == list(ref_regimes)
    for label, topo in ref_regimes.items():
        for alg in mod.ALGS:
            want = bench.run_algorithm("paper-mlp", alg, alpha=0.0,
                                       steps=round(200 * f), smoke=True, lr=0.1,
                                       eval_every=2, local_steps=10,
                                       batch_per_client=8, topology=topo)
            same(got[(label, alg)], want, (label, alg))
