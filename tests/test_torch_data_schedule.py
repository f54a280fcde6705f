"""The port's data and schedule streams against the JAX reference's: the
same seeds must give byte-identical numpy batches (`client_batches`, both
paper classifiers, two seeds, heterogeneity alpha and pixel noise on) and
equal schedules (`schedule_stream`: mask, budget and sizes over 5 rounds
under participation, straggler and capability-batching configs)."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedule as jax_schedule
from repro.data.pipeline import client_batches as jax_client_batches
from repro.data.synthetic import MultiTaskImageSource as JaxSource
from repro_torch.configs import get_config
from repro_torch.core import schedule
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("arch", ["paper-mlp", "paper-resnet16"])
def test_client_batches_are_byte_identical(arch, seed):
    cfg = get_config(arch)
    assert cfg.__dict__ == jax_get_config(arch).__dict__
    kw = dict(num_classes=cfg.num_clients, image_size=cfg.image_size,
              channels=cfg.image_channels, alpha=0.3, noise_sigma=0.5, seed=seed)
    ours = client_batches(MultiTaskImageSource(**kw), 4, steps=3, seed=seed)
    ref = jax_client_batches(JaxSource(**kw), 4, steps=3, seed=seed, as_numpy=True)
    n = 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b) == ["image", "label"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
        n += 1
    assert n == 3


SCHEDULES = {
    "participation": dict(participation_rate=0.4, seed=5),
    "stragglers": dict(straggler_frac=0.5, seed=2),
    "capability": dict(capability_batching=True, straggler_frac=0.6,
                       participation_rate=0.7, seed=9),
    "full": dict(),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_stream_matches(name):
    kw = SCHEDULES[name]
    M, steps, b = 10, 4, 8
    ours = schedule.schedule_stream(schedule.ScheduleConfig(**kw), M, steps, b)
    ref = jax_schedule.schedule_stream(jax_schedule.ScheduleConfig(**kw), M, steps, b)
    for _ in range(5):
        a, r = next(ours), next(ref)
        np.testing.assert_array_equal(a.mask, np.asarray(r.mask))
        assert a.mask.dtype == np.float32
        np.testing.assert_array_equal(a.budget, np.asarray(r.budget))
        if r.sizes is None:
            assert a.sizes is None
        else:
            np.testing.assert_array_equal(a.sizes, np.asarray(r.sizes))
        assert a.num_participants == r.num_participants
        assert a.samples_per_step == r.samples_per_step
    scfg = schedule.ScheduleConfig(**kw)
    assert schedule.padded_batch_per_client(scfg, b) == \
        jax_schedule.padded_batch_per_client(jax_schedule.ScheduleConfig(**kw), b)


def test_sample_mask_matches():
    sizes = np.array([0, 3, 8, 1], np.int32)
    ours = schedule.sample_mask(torch.from_numpy(sizes), 8).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_schedule.sample_mask(sizes, 8)))
