"""No module a run loads is JAX or the reference package `repro`, and the
reference loads nothing of the program, each compared by its whole
top-level name (the program's `repro_torch` begins with `repro`)."""
import json
import subprocess
import sys

from perfbench.tests import smoke

RUN = """
import sys, json
sys.path[:0] = [{root!r}, {root!r} + '/src']
from perfbench.tests import smoke
for name in smoke.workloads():
    rc, line, err = smoke.run(smoke.cell(name), seconds=0.2)
    assert rc == 0, err
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
REFERENCE = """
import sys, json
sys.path[:0] = [{root!r}]
import perfbench.reference.model, perfbench.reference.train, perfbench.lib.weights
import perfbench.yardstick.flops, perfbench.yardstick.costs, perfbench.lib.lm_data
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code.format(root=str(smoke.ROOT))],
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package():
    mods = _modules(RUN)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods & {"jax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
