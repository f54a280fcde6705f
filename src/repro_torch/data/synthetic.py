"""Synthetic multi-task image data with the paper's heterogeneity machinery.

The container is offline (no MNIST/CIFAR downloads), so we generate
class-conditional images: each class has a deterministic smooth prototype
pattern; a sample is prototype + within-class jitter (+ optional pixel-wise
Gaussian noise — paper Fig. 4b). The paper's Eq. 13 label mixing gives each
task m the distribution

    P(Y_m = m) = 1 - alpha,   P(Y_m = n) = alpha / (M - 1)  (n != m)

with alpha in [0, 1-1/M]: alpha=0 -> maximal heterogeneity (one class per
task); alpha = 1-1/M -> i.i.d. tasks. DESIGN.md §7 documents why qualitative
(not absolute) agreement with the paper's MNIST/CIFAR numbers is the target.

A verbatim copy of `repro.data.synthetic` (numpy only): the same seed gives
byte-identical batches in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


def heterogeneous_label_dist(num_classes: int, task: int, alpha: float) -> np.ndarray:
    """Paper Eq. 13."""
    assert 0.0 <= alpha <= 1.0 - 1.0 / num_classes + 1e-9
    p = np.full(num_classes, alpha / (num_classes - 1))
    p[task] = 1.0 - alpha
    return p


def _smooth_field(rng: np.random.Generator, size: int, channels: int, octaves=3):
    """Deterministic smooth random pattern (poor-man's Perlin)."""
    img = np.zeros((size, size, channels), np.float32)
    for o in range(octaves):
        k = 2 ** (o + 1)
        coarse = rng.normal(size=(k, k, channels)).astype(np.float32)
        # bilinear upsample
        xs = np.linspace(0, k - 1, size)
        x0 = np.floor(xs).astype(int)
        x1 = np.minimum(x0 + 1, k - 1)
        wx = (xs - x0)[:, None]
        rows = coarse[x0] * (1 - wx[..., None]) + coarse[x1] * wx[..., None]
        rows = rows.transpose(1, 0, 2)
        cols = rows[x0] * (1 - wx[..., None]) + rows[x1] * wx[..., None]
        img += cols.transpose(1, 0, 2) / (o + 1)
    return img


@dataclass
class MultiTaskImageSource:
    """num_tasks tasks over num_classes classes (paper: one class per task).

    `num_tasks=None` (default) keeps the paper's one-task-per-class setup
    (M == C). Setting it decouples the client count from the class count —
    task m's main class is `m % num_classes` — so massive-M scaling sweeps
    (benchmarks/scaling.py) can grow the client axis against a fixed model
    head. The default draw order is byte-identical to the historical
    source; `all_tasks_batch(..., vectorized=True)` switches to a batched
    across-clients RNG draw (different, still seeded, stream) whose host
    cost stays flat per client as M grows.
    """

    num_classes: int = 10
    image_size: int = 28
    channels: int = 1
    alpha: float = 0.0  # heterogeneity (Eq. 13)
    noise_sigma: float = 0.0  # pixel-wise Gaussian noise (Fig. 4b)
    jitter: float = 1.5  # within-class variability
    class_sep: float = 0.3  # class-delta scale vs the shared base pattern
    seed: int = 0
    num_tasks: int | None = None  # clients; None -> num_classes (paper)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # classes share a base pattern and differ by a scaled delta — keeps
        # them partially confusable (MNIST-like overlap), so conflicting
        # gradients actually hurt the federated baselines as in the paper.
        base = _smooth_field(rng, self.image_size, self.channels)
        self.prototypes = np.stack(
            [
                base + self.class_sep * _smooth_field(rng, self.image_size, self.channels)
                for _ in range(self.num_classes)
            ]
        )  # [C, H, W, ch]

    def sample_class(self, rng: np.random.Generator, labels: np.ndarray) -> np.ndarray:
        base = self.prototypes[labels]
        x = base + self.jitter * rng.normal(size=base.shape).astype(np.float32)
        if self.noise_sigma > 0:
            x = x + self.noise_sigma * rng.normal(size=x.shape).astype(np.float32)
        return x.astype(np.float32)

    @property
    def tasks(self) -> int:
        return self.num_tasks if self.num_tasks is not None else self.num_classes

    def task_batch(self, rng: np.random.Generator, task: int, batch: int):
        """One task's batch: labels ~ Eq. 13, images class-conditional."""
        p = heterogeneous_label_dist(
            self.num_classes, task % self.num_classes, self.alpha)
        labels = rng.choice(self.num_classes, size=batch, p=p)
        return self.sample_class(rng, labels), labels

    def all_tasks_batch(self, rng: np.random.Generator, batch_per_task: int,
                        vectorized: bool = False):
        """[M, b, H, W(, ch)] images + [M, b] labels (training batch).

        vectorized=False is the historical per-task loop (byte-identical
        seeded stream — the parity goldens depend on its draw order).
        vectorized=True draws every task's labels with one inverse-CDF pass
        and every image with one batched normal draw: the host cost per
        client stays flat as M grows, keeping the async pipeline's
        background thread off the critical path at massive M. The two modes
        sample the same distribution from different (seeded) streams.
        """
        if vectorized:
            return self._all_tasks_batch_vectorized(rng, batch_per_task)
        imgs, labs = [], []
        for m in range(self.tasks):
            x, y = self.task_batch(rng, m, batch_per_task)
            imgs.append(x)
            labs.append(y)
        x = np.stack(imgs)
        if self.channels == 1:
            x = x[..., 0]
        return x, np.stack(labs)

    def _all_tasks_batch_vectorized(self, rng: np.random.Generator,
                                    batch_per_task: int):
        T, C = self.tasks, self.num_classes
        # [T, C] per-task label distributions (Eq. 13), one inverse-CDF draw
        P = np.stack([
            heterogeneous_label_dist(C, m % C, self.alpha) for m in range(T)
        ])
        cum = np.cumsum(P, axis=1)  # [T, C], last column == 1
        u = rng.random((T, batch_per_task))
        labels = np.minimum(
            (cum[:, None, :] < u[:, :, None]).sum(axis=-1), C - 1)
        base = self.prototypes[labels]  # [T, b, H, W, ch]
        x = base + self.jitter * rng.normal(size=base.shape).astype(np.float32)
        if self.noise_sigma > 0:
            x = x + self.noise_sigma * rng.normal(
                size=x.shape).astype(np.float32)
        x = x.astype(np.float32)
        if self.channels == 1:
            x = x[..., 0]
        return x, labels

    def test_batch(self, rng: np.random.Generator, task: int, batch: int):
        """Paper §4.1: each task is *tested on its main label only*."""
        labels = np.full(batch, task % self.num_classes)
        x = self.sample_class(rng, labels)
        if self.channels == 1:
            x = x[..., 0]
        return x, labels
