"""Synthetic heterogeneous LM data: per-client Markov chains (a copy of
`repro.data.lm.MultiTaskLMSource`; numpy only, so the port does not
import the reference).

Each client's stream is a first-order Markov chain whose transition
matrix interpolates between a shared chain and a client-private chain:

    P_m = (1 - beta) * P_shared + beta * P_m_private

beta plays the role of the paper's heterogeneity (beta=0 -> i.i.d.
clients; beta=1 -> fully disjoint structure). A bigram model can reach the
entropy floor, so loss curves are meaningful.

The chains are dense f64 [V, V] matrices: 134 MB each at V = 4096, 8.2 GB
at V = 32,000. The same seed gives the reference's chains and draws byte
for byte. Unlike the reference, each chain's row-wise CDF is computed once
and kept (the reference recomputes `np.cumsum(P)` on every draw; the values
are the same).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _random_transition(rng: np.random.Generator, vocab: int, concentration=0.3):
    p = rng.gamma(concentration, size=(vocab, vocab)).astype(np.float64)
    p /= p.sum(axis=1, keepdims=True)
    return p


@dataclass
class MultiTaskLMSource:
    vocab_size: int = 256
    num_clients: int = 4
    beta: float = 1.0  # heterogeneity
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        shared = _random_transition(rng, self.vocab_size)
        self.chains = []
        for _ in range(self.num_clients):
            private = _random_transition(rng, self.vocab_size)
            p = (1 - self.beta) * shared + self.beta * private
            self.chains.append(p / p.sum(axis=1, keepdims=True))
        self._cums = [None] * self.num_clients

    def _cum(self, client: int) -> np.ndarray:
        if self._cums[client] is None:
            self._cums[client] = np.cumsum(self.chains[client], axis=1)
        return self._cums[client]

    def client_tokens(self, rng: np.random.Generator, client: int, batch: int,
                      seq: int):
        cum = self._cum(client)
        out = np.empty((batch, seq), np.int64)
        state = rng.integers(0, self.vocab_size, size=batch)
        out[:, 0] = state
        for t in range(1, seq):
            u = rng.random(batch)
            # clamp the inverse-CDF draw: fp rounding can leave cum's last
            # column below 1.0, and a u above it would yield an
            # out-of-range token (the clamp only fires on that overflow)
            state = np.minimum((cum[state] < u[:, None]).sum(axis=1),
                               self.vocab_size - 1)
            out[:, t] = state
        return out

    def all_clients_batch(self, rng: np.random.Generator,
                          batch_per_client: int, seq: int,
                          vectorized: bool = False):
        """[M, b, S] token batch.

        vectorized=False draws client by client (the reference's default
        draw order). vectorized=True advances ALL clients' chains with one
        batched inverse-CDF draw per position (the reference's vectorized
        draw, byte for byte): host cost per client flat in M. Same
        distribution, different seeded stream."""
        if not vectorized:
            return np.stack([self.client_tokens(rng, m, batch_per_client, seq)
                             for m in range(self.num_clients)])
        M, V, b = self.num_clients, self.vocab_size, batch_per_client
        cums = np.stack([self._cum(m) for m in range(M)])  # [M, V, V]
        out = np.empty((M, b, seq), np.int64)
        state = rng.integers(0, V, size=(M, b))
        out[..., 0] = state
        midx = np.arange(M)[:, None]
        for t in range(1, seq):
            u = rng.random((M, b))
            # the same overflow clamp as the per-client path
            state = np.minimum(
                (cums[midx, state] < u[..., None]).sum(axis=-1), V - 1)
            out[..., t] = state
        return out

    def entropy_floor(self, client: int) -> float:
        """Stationary conditional entropy of client's chain (nats/token)."""
        P = self.chains[client]
        # stationary distribution via power iteration
        pi = np.full(P.shape[0], 1.0 / P.shape[0])
        for _ in range(500):
            pi = pi @ P
        h = -np.sum(pi[:, None] * P * np.log(P + 1e-12))
        return float(h)
