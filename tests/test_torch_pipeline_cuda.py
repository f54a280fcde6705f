"""The systems layers on the card: the prefetch pipeline's staging on a
side CUDA stream, the loop at prefetch 2 against prefetch 0, and the scan
round at two M. Marked `cuda`: they skip without a card. The
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_pipeline_cuda.py

  * Staging: `pipeline_rounds(depth=2)` copies each batch from pinned
    memory on a side stream while the compute stream runs a round that
    spins (`torch.cuda._sleep`) before it reads the batch it was given.
    Every round must read its own batch's values, with the caching
    allocator free to reuse released staging buffers.
  * The loop: paper-mlp through `train` at prefetch 0 and 2 on the card,
    same history and bit-equal state, one K1 launch a round.
  * The scan round at M = 4 and 8 with chunk 2: M/2 + 1 K1 launches a
    round, within 1e-5 of the dense round's loss, both on the same
    per-block functions.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.core.scan_round import build_mtsl_scan_round
from repro_torch.core.schedule import full_schedule
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.train.loop import TrainConfig, stage_batch, train
from repro_torch.train.pipeline import host_batch, pipeline_rounds
from repro_torch.utils.device import generator
from repro_torch.utils.tree import tree_leaves_with_path


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staging stream and K1 run on the card")


@pytest.mark.cuda
def test_staging_on_a_side_stream_while_the_round_reads():
    _need_card()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.normal(size=(4, 64, 1024)).astype(np.float32),
                "label": rng.integers(0, 10, size=(4, 64)).astype(np.int32)}
               for _ in range(16)]
    assert host_batch(batches[0], pin=True)["image"].is_pinned()
    compute = torch.cuda.current_stream()
    sums = []
    for batch, sched in pipeline_rounds(iter(batches), itertools.count(), depth=2,
                                        device="cuda"):
        assert batch["image"].is_cuda and batch["label"].dtype == torch.int64
        torch.cuda._sleep(5_000_000)  # the round is busy while the next copy runs
        sums.append((sched, (batch["image"].double().sum()
                             + batch["label"].double().sum())))
        assert torch.cuda.current_stream() == compute
        del batch
    torch.cuda.synchronize()
    for i, s in sums:
        want = (batches[i]["image"].astype(np.float64).sum()
                + batches[i]["label"].astype(np.float64).sum())
        assert abs(float(s) - want) <= 1e-9 * max(1.0, abs(want))


@pytest.mark.cuda
def test_prefetch_two_equals_zero_on_the_card():
    _need_card()
    cfg = get_config("paper-mlp", smoke=True)
    M, model = cfg.num_clients, build_model(cfg)
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for depth in (0, 2):
            n0 = mtsl_update_multi_.launches
            state, hist = train(model, sgd(0.1), client_batches(src, 8, seed=0),
                                TrainConfig(steps=12, log_every=1, device="cuda",
                                            prefetch=depth), M, log=lambda _: None)
            assert mtsl_update_multi_.launches - n0 == 12
            out[depth] = ([e["loss"] for e in hist],
                          dict(tree_leaves_with_path(state.params)))
    finally:
        torch.use_deterministic_algorithms(False)
    assert out[0][0] == out[2][0]
    assert all(torch.equal(out[0][1][k], out[2][1][k]) for k in out[0][1])


@pytest.mark.cuda
def test_scan_round_one_build_across_m_on_the_card():
    _need_card()
    cfg = get_config("paper-mlp", smoke=True)
    model, chunk, lr = build_model(cfg), 2, 0.05
    alg = get_algorithm("mtsl")
    rng = np.random.default_rng(0)
    kernels = []
    for M in (4, 8):
        hp = HParams(lr=lr)
        batch = stage_batch({
            "image": rng.normal(size=(M, 8, cfg.image_size, cfg.image_size))
            .astype(np.float32),
            "label": rng.integers(0, cfg.num_classes, size=(M, 8)).astype(np.int32)},
            "cuda")
        dense, scan = alg.round_fn(model, M, hp), build_mtsl_scan_round(model, M, hp,
                                                                          chunk=chunk)
        s_d = alg.init_state(model, generator("cuda", 0), M, hp)
        s_s = alg.init_state(model, generator("cuda", 0), M, hp)
        for _ in range(3):
            s_d, m_d = dense(s_d, batch, full_schedule(M, 1))
            n0 = mtsl_update_multi_.launches
            s_s, m_s = scan(s_s, batch, full_schedule(M, 1))
            assert mtsl_update_multi_.launches - n0 == M // chunk + 1
            scale = max(1.0, abs(float(m_d["loss"])))
            assert abs(float(m_d["loss"]) - float(m_s["loss"])) <= 1e-5 * scale
        kernels.append(scan.kernels)
    assert kernels[0] is kernels[1]
