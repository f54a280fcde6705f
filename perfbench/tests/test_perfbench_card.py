"""Each cell at the smoke sizes on the card (skips without one): the CUDA
kernels on the path, the traced stretch's kernel records held against the
program's launch counters, `correct` against the float32 reference.

    PYTHONPATH=src python -m pytest -q --noconftest perfbench/tests/test_perfbench_card.py
"""
import time

import pytest
import torch

from perfbench.tests import smoke


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", smoke.workloads())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(name, trace):
    dev = _card()
    from perfbench.lib import result

    w = smoke.cell(name)
    t0 = time.perf_counter()
    out = result.emit(w, 2**32 + 3, 1.0, trace, dev, lambda: time.perf_counter() - t0)
    assert out == 0
