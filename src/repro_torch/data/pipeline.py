"""Batch pipeline (port of `repro.data.pipeline.client_batches`, its
synthesis branches): yields host-side numpy round batches with the
`[M, b, ...]` client-leading layout the MTSL step expects. The train loop
stages them on the device. The draw order is the reference's, so the same
seed gives byte-identical batches in both packages.

The reference's cached `ShardableDataset` branch (`data/shards.py`) is not
ported yet.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def client_batches(
    source,
    batch_per_client: int,
    *,
    steps: Optional[int] = None,
    seed: int = 0,
    seq_len: Optional[int] = None,
) -> Iterator[dict]:
    """Yield numpy batches, `steps` of them (None: forever), in the
    reference's default per-client draw order: `{"image": [M, b, H, W(, C)]
    f32, "label": [M, b] int32}` from a `MultiTaskImageSource`, or
    `{"tokens": [M, b, seq_len] int32}` from a `MultiTaskLMSource`. (The
    reference's `vectorized` draw, a launcher option, is not ported.)"""
    if hasattr(source, "round_batch"):
        raise NotImplementedError(
            "cached datasets (data/shards.py) are not ported yet: pass a "
            "MultiTaskImageSource")
    is_lm = hasattr(source, "chains")
    if is_lm and seq_len is None:
        raise ValueError("an LM source needs seq_len")
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        if is_lm:
            toks = source.all_clients_batch(rng, batch_per_client, seq_len)
            yield {"tokens": np.asarray(toks, np.int32)}
        else:
            x, y = source.all_tasks_batch(rng, batch_per_client)
            yield {"image": np.asarray(x), "label": np.asarray(y, np.int32)}
        i += 1
