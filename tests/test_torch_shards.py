"""The port's cached client data (`repro_torch.data.shards`) and the cached
and vectorized branches of its `client_batches`, against `repro.data`.

  * The same parameters build byte-identical caches in both packages
    (every shard file, the manifest and `cache_fingerprint`): per-client
    caches of an image and an LM source, and a Dirichlet(0.3) cache of a
    pooled corpus. Each package's `round_batch` over either cache is
    byte-equal to the other's.
  * The `vectorized` draw is byte-equal to the reference's (image, LM).
  * Reshard invariance (any `shard(i, n)` partition reassembles the round)
    and the `start_round` seek (a resumed stream draws an uninterrupted
    one's batches).
  * Training from the cache equals training on the same rows held in
    memory, bit for bit, through the loop at prefetch 2.
"""
import functools

import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.data import shards as jax_shards
from repro.data.lm import MultiTaskLMSource as JaxLM
from repro.data.synthetic import MultiTaskImageSource as JaxImage
from repro_torch.configs import get_config
from repro_torch.data import shards
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.train.loop import TrainConfig, train

M = 4
IMG = dict(num_classes=M, image_size=8, channels=1, alpha=0.5, seed=0)
LM = dict(vocab_size=32, num_clients=M, beta=0.5, seed=0)


def _files(d):
    import os

    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _same_dir(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    assert all(fa[k] == fb[k] for k in fa)
    assert shards.cache_fingerprint(a) == jax_shards.cache_fingerprint(b)


def _same_batch(x, y):
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
        assert x[k].tobytes() == np.asarray(y[k]).tobytes()


@pytest.mark.parametrize("kind", ["image", "lm", "dirichlet"])
def test_builds_are_byte_identical_across_packages(kind, tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    if kind == "image":
        shards.build_cache(a, MultiTaskImageSource(**IMG), 40, shard_size=16, seed=1)
        jax_shards.build_cache(b, JaxImage(**IMG), 40, shard_size=16, seed=1)
    elif kind == "lm":
        shards.build_cache(a, MultiTaskLMSource(**LM), 20, seq_len=12, shard_size=8,
                           seed=1)
        jax_shards.build_cache(b, JaxLM(**LM), 20, seq_len=12, shard_size=8, seed=1)
    else:
        corpus = shards.pooled_corpus(MultiTaskImageSource(**IMG), 96, seed=2)
        corpus_j = jax_shards.pooled_corpus(JaxImage(**IMG), 96, seed=2)
        _same_batch(corpus, corpus_j)
        shards.build_dirichlet_cache(a, corpus, M, 0.3, shard_size=16, seed=2)
        jax_shards.build_dirichlet_cache(b, corpus_j, M, 0.3, shard_size=16, seed=2)
    _same_dir(a, b)
    kw = {"seq_len": 10} if kind == "lm" else {}
    for r in (0, 3):
        # each package reads the cache the other built
        _same_batch(shards.load_cache(b).round_batch(7, r, 5, **kw),
                    jax_shards.load_cache(a).round_batch(7, r, 5, **kw))


@pytest.mark.parametrize("kind", ["image", "lm"])
def test_vectorized_draw_matches_reference(kind):
    if kind == "image":
        src, src_j, kw = MultiTaskImageSource(**IMG), JaxImage(**IMG), {}
    else:
        src, src_j, kw = MultiTaskLMSource(**LM), JaxLM(**LM), {"seq_len": 9}
    got = list(client_batches(src, 6, steps=3, seed=4, vectorized=True, **kw))
    want = list(jax_pipeline.client_batches(src_j, 6, steps=3, seed=4,
                                            vectorized=True, as_numpy=True, **kw))
    for x, y in zip(got, want):
        _same_batch(x, y)
    plain = next(client_batches(src, 6, steps=1, seed=4, **kw))
    assert any(plain[k].tobytes() != got[0][k].tobytes() for k in plain)


@functools.lru_cache(maxsize=None)
def _image_cache(root):
    d = f"{root}/img"
    shards.build_cache(d, MultiTaskImageSource(**IMG), 40, shard_size=16, seed=1)
    return d


def test_reshard_invariance_and_start_round_seek(tmp_path):
    ds = shards.load_cache(_image_cache(str(tmp_path)))
    full = ds.round_batch(3, 5, 6)
    for n in (2, 4):
        parts = [ds.shard(i, n) for i in range(n)]
        rows = {m: (p, j) for p in parts for j, m in enumerate(p.clients)}
        got = {f: np.stack([parts_batch[f][j] for m in range(M)
                            for p, j in [rows[m]]
                            for parts_batch in [p.round_batch(3, 5, 6)]])
               for f in full}
        _same_batch(got, full)
    stream = list(client_batches(ds, 6, steps=5, seed=3))
    seek = list(client_batches(ds, 6, steps=2, seed=3, start_round=3))
    for x, y in zip(seek, stream[3:]):
        _same_batch(x, y)
    with pytest.raises(ValueError, match="start_round"):
        next(client_batches(MultiTaskImageSource(**IMG), 6, start_round=1))


def test_cached_training_matches_in_memory_training(tmp_path):
    cfg = get_config("paper-mlp", smoke=True).with_updates(num_clients=M)
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    d = str(tmp_path / "c")
    shards.build_cache(d, src, 32, seed=1)
    mem = shards.materialize_source(src, 32, seed=1)
    model = build_model(cfg)
    runs = []
    for ds in (shards.load_cache(d), mem):
        tcfg = TrainConfig(steps=4, algorithm="mtsl", lr=0.05, log_every=1,
                           device="cpu", prefetch=2)
        runs.append(train(model, sgd(0.05), client_batches(ds, 4, seed=2), tcfg, M,
                          log=lambda _: None))
    (s_c, h_c), (s_m, h_m) = runs
    assert [e["loss"] for e in h_c] == [e["loss"] for e in h_m]
    for a, b in zip(s_c.params["towers"].values(), s_m.params["towers"].values()):
        for k in a:
            assert torch.equal(a[k], b[k])
