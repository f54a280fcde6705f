"""The reference (perfbench/reference) against the program at the smoke
sizes on the CPU, in float32, and its SSD scan against the plain
recurrence."""
import numpy as np
import pytest
import torch

from perfbench.tests import smoke
from perfbench.lib import mtsl_train, weights
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

TRAIN = [n for n in smoke.workloads() if n.endswith("mtsl-train")]


def test_ssd_chunks_equal_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, L, H, P, N = 2, 24, 3, 4, 5
    x = torch.randn(B, L, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(B, L, H, generator=g, dtype=torch.float64)
    A = -torch.rand(H, generator=g, dtype=torch.float64) - 0.1
    Bm = torch.randn(B, L, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(B, L, N, generator=g, dtype=torch.float64)
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    want = []
    for t in range(L):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        want.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    got = ref_model.ssd(x, dt, A, Bm, Cm, chunk=8)
    assert torch.allclose(got, torch.stack(want, 1), atol=1e-10)


@pytest.mark.parametrize("name", TRAIN)
def test_training_rounds_match_the_program(name):
    w = smoke.cell(name)
    seed = 2**33 + 5
    p = mtsl_train.prepare(w, seed, torch.device("cpu"))
    numbers, ref = mtsl_train.check(w, seed, p.prog, p.first, p.spec, torch.device("cpu"))
    assert numbers["loss_gap"]["value"] < 1e-5
    assert numbers["grad_gap"]["value"] < 1e-4
    assert numbers["change_gap"]["value"] < 2e-3  # f32 round-off of w - w_0
    assert len(ref["grad"]) == len(p.spec) and all(np.isfinite(ref["loss"]))


def test_weights_are_drawn_again_alike():
    w = smoke.cell(TRAIN[0])
    spec = weights.specs(w["cfg"], 2)
    made = weights.make_params(spec, 12345, "cpu")
    again = dict(weights.initial_leaves(spec, 12345, "cpu"))
    assert all(torch.equal(made[n], again[n]) for n in made)
    other = weights.make_params(spec, 12346, "cpu")
    assert not torch.equal(made["server/head/w"], other["server/head/w"])


def test_reference_follows_the_component_rates():
    assert ref_train.eta("towers/layers/0/mamba/wz", 0.05, 2) == 0.05
    assert ref_train.eta("server/head/w", 0.05, 2) == 0.025
