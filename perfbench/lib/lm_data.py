"""Training traffic: a frozen copy of the program's synthetic multi-task
LM source (`repro_torch.data.lm.MultiTaskLMSource`) and of the LM branch
of its round-batch generator (`repro_torch.data.pipeline.client_batches`),
so that the traffic does not move when the program changes.

Each client's tokens follow its own first-order Markov chain over
`vocab` ids, P_m = (1 - beta) P_shared + beta P_private (beta is the
paper's heterogeneity); a round batch is [M, b, S] int32, client by
client, from one numpy generator seeded by the run's seed.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def _random_transition(rng: np.random.Generator, vocab: int, concentration=0.3):
    p = rng.gamma(concentration, size=(vocab, vocab)).astype(np.float64)
    p /= p.sum(axis=1, keepdims=True)
    return p


class MultiTaskLMSource:
    def __init__(self, vocab_size: int, num_clients: int, beta: float, seed: int):
        rng = np.random.default_rng(seed)
        shared = _random_transition(rng, vocab_size)
        self.vocab_size, self.num_clients = vocab_size, num_clients
        self.cums = []
        for _ in range(num_clients):
            p = (1 - beta) * shared + beta * _random_transition(rng, vocab_size)
            self.cums.append(np.cumsum(p / p.sum(axis=1, keepdims=True), axis=1))

    def client_tokens(self, rng: np.random.Generator, client: int, batch: int,
                      seq: int) -> np.ndarray:
        cum = self.cums[client]
        out = np.empty((batch, seq), np.int64)
        state = rng.integers(0, self.vocab_size, size=batch)
        out[:, 0] = state
        for t in range(1, seq):
            u = rng.random(batch)
            state = np.minimum((cum[state] < u[:, None]).sum(axis=1),
                               self.vocab_size - 1)
            out[:, t] = state
        return out


def client_batches(source: MultiTaskLMSource, batch_per_client: int, seq_len: int,
                   seed: int, steps: Optional[int] = None) -> Iterator[dict]:
    """{"tokens": [M, b, S] int32} round batches, `steps` of them (None:
    without end)."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        toks = np.stack([source.client_tokens(rng, m, batch_per_client, seq_len)
                         for m in range(source.num_clients)])
        yield {"tokens": np.asarray(toks, np.int32)}
        i += 1
