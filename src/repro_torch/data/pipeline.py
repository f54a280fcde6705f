"""Batch pipeline (port of `repro.data.pipeline.client_batches`): yields
host-side numpy round batches with the `[M, b, ...]` client-leading
layout the MTSL step expects. The train loop stages them on the device
(train/pipeline.py). The draw order is the reference's, so the same seed
gives byte-identical batches in both packages.

The source can be a synthesis source (`MultiTaskImageSource` /
`MultiTaskLMSource`) or any `ShardableDataset` (data/shards.py): with a
dataset, each round is a deterministic mmap'd shard READ keyed on
`(seed, round)`, so the prefetch thread stops synthesising. Cached rounds
are random access, so `start_round` lets a resumed run seek mid-stream
instead of replaying and discarding the consumed rounds.
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
    vectorized: bool = False,
    start_round: int = 0,
) -> Iterator[dict]:
    """Yield numpy batches, `steps` of them (None: forever): `{"image":
    [M, b, H, W(, C)] f32, "label": [M, b] int32}` from a
    `MultiTaskImageSource`, `{"tokens": [M, b, seq_len] int32}` from a
    `MultiTaskLMSource`, or a ShardableDataset's `round_batch` rows.

    `vectorized=True` draws each round with the sources' batched
    across-clients RNG paths (the reference's: same distribution, a
    different seeded stream, host cost per client flat in M); it has no
    effect on datasets. `start_round` (datasets only) starts the stream at
    that absolute round."""
    if hasattr(source, "round_batch"):  # ShardableDataset: cached reads
        kwargs = {"seq_len": seq_len} if source.kind == "lm" else {}
        i = 0
        while steps is None or i < steps:
            yield source.round_batch(seed, start_round + i, batch_per_client,
                                     **kwargs)
            i += 1
        return
    if start_round:
        raise ValueError(
            "start_round requires a ShardableDataset source: synthesis "
            "sources are sequential streams — replay them and slice off "
            "the consumed rounds instead")
    is_lm = hasattr(source, "chains")
    if is_lm and seq_len is None:
        raise ValueError("an LM source needs seq_len")
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        if is_lm:
            toks = source.all_clients_batch(rng, batch_per_client, seq_len,
                                            vectorized=vectorized)
            yield {"tokens": np.asarray(toks, np.int32)}
        else:
            x, y = source.all_tasks_batch(rng, batch_per_client,
                                          vectorized=vectorized)
            yield {"image": np.asarray(x), "label": np.asarray(y, np.int32)}
        i += 1
