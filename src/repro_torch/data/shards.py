"""Cached, shardable client-data layer (the levanter cache shape).

A verbatim copy of `repro.data.shards` (numpy only; the port does not
import the reference): the same parameters build byte-identical caches in
both packages, so either package reads a cache the other built.

The paper's premise is heterogeneous per-client data SOURCES, but until
this module every round re-synthesized every client's batch on the host —
at massive M the `BackgroundIterator` thread becomes the critical path,
and there was no way to feed real non-IID shards. This module gives the
training loop a `ShardableDataset`:

  * **Build-once on-disk cache** — `build_cache` materializes each
    client's stream from any source (`MultiTaskImageSource`,
    `MultiTaskLMSource`, or a Dirichlet-partitioned labeled corpus) into
    per-client shard files (`client-00042/image-00000.npy`, ...) plus a
    `manifest.json`. Builds are byte-stable: generation is chunked by a
    FIXED `_GEN_CHUNK` (so the per-client RNG stream never depends on the
    shard size) and shard files are raw `.npy` (no timestamps), so two
    builds with the same parameters produce identical bytes
    (`cache_fingerprint` pins it).
  * **Deterministic, resharding-invariant iteration** — a round batch is
    assembled per client from `default_rng([_SAMPLE_TAG, seed, round,
    global_client_id])`: the same `(seed, round)` yields the same
    `[M, b, ...]` rows no matter how the dataset is sharded
    (`.shard(index, count)`), chunked on disk (`shard_size`), or laid out
    over a mesh — reassembling any shard partition's `round_batch` rows
    by global client id reproduces the unsharded batch exactly, so
    goldens pin it once.
  * **Dirichlet splits** — `dirichlet_partition` implements the standard
    non-IID heterogeneity protocol (FedProx / ParallelSFL line of work):
    per class, client proportions ~ Dirichlet(alpha); small alpha means
    near-disjoint label distributions per client.

`data/pipeline.client_batches` accepts any `ShardableDataset` in place of
a synthesis source: the async pipeline's background thread
(train/pipeline.py) then performs cheap mmap'd shard READS instead of
per-round synthesis, which is what keeps it off the critical path at
large M (benchmarks/throughput.py measures the win). Sampling is with
replacement from the client's cached examples — an exchangeable stream,
which is what makes resharding invariance exact.
"""
from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

FORMAT = "repro-client-cache-v1"

# SeedSequence entropy tags: build-time generation, round sampling, pooled
# corpus synthesis, and Dirichlet partitioning draw from DISJOINT streams
_BUILD_TAG = 0x0B11D
_SAMPLE_TAG = 0x5A3C
_CORPUS_TAG = 0xC0B05
_DIRICHLET_TAG = 0xD121C

# fixed generation chunk: build/materialize draw each client's examples in
# chunks of this many rows, so the per-client RNG stream (and therefore
# the cached bytes) never depends on shard_size or examples_per_client
_GEN_CHUNK = 256

# cap on simultaneously open shard mmaps (file handles)
_MMAP_CAP = 128


def round_indices(seed: int, round_idx: int, client: int,
                  num_examples: int, batch: int) -> np.ndarray:
    """The per-(seed, round, GLOBAL client) example draw.

    This is the whole resharding-invariance story: the stream depends only
    on values every shard agrees on, never on shard layout or position."""
    rng = np.random.default_rng(
        [_SAMPLE_TAG, int(seed), int(round_idx), int(client)])
    return rng.integers(0, num_examples, size=batch)


class ShardableDataset:
    """Contract: a per-client example store with deterministic round draws.

    Subclasses provide `_take(global_client, idx) -> {field: [b, ...]}`
    row gathers and set `kind` ("image" | "lm"), `fields`
    ({name: {"dtype", "shape"}}), `num_clients_total`, `clients` (the
    GLOBAL client ids this view covers, in order), and `_counts`
    (examples per global client). Everything else — sharding views and
    round-batch assembly — is shared here.
    """

    kind: str
    fields: Dict[str, dict]
    num_clients_total: int
    clients: tuple
    _counts: Dict[int, int]
    seq_len: Optional[int] = None

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def num_examples(self, client: int) -> int:
        return self._counts[client]

    def shard(self, index: int, count: int) -> "ShardableDataset":
        """A view over every count-th client starting at `index`.

        Round-robin (levanter-style) so ranks stay balanced; iteration is
        invariant either way because draws key on GLOBAL client ids."""
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} not in [0, {count})")
        return self._with_clients(self.clients[index::count])

    def _with_clients(self, clients: Sequence[int]) -> "ShardableDataset":
        raise NotImplementedError

    def _take(self, client: int, idx: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def round_batch(self, seed: int, round_idx: int, batch_per_client: int,
                    *, seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        """`{field: [num_clients, b, ...]}` for this view's clients.

        Same (seed, round_idx) -> same rows for a given global client id,
        regardless of sharding/chunking (see module docstring)."""
        b = int(batch_per_client)
        out = {
            f: np.empty((len(self.clients), b) + tuple(spec["shape"]),
                        np.dtype(spec["dtype"]))
            for f, spec in self.fields.items()
        }
        for row, m in enumerate(self.clients):
            idx = round_indices(seed, round_idx, m, self.num_examples(m), b)
            rows = self._take(m, idx)
            for f in out:
                out[f][row] = rows[f]
        if seq_len is not None:
            if self.kind != "lm":
                raise ValueError("seq_len only applies to lm caches")
            if self.seq_len is not None and seq_len > self.seq_len:
                raise ValueError(
                    f"requested seq_len {seq_len} exceeds the cached "
                    f"sequence length {self.seq_len}")
            out["tokens"] = np.ascontiguousarray(out["tokens"][..., :seq_len])
        return out

    def client_array(self, client: int, field: str) -> np.ndarray:
        """All of one client's rows for `field` (tests / label stats)."""
        return self._take(client, np.arange(self.num_examples(client)))[field]


class InMemoryClientDataset(ShardableDataset):
    """All clients' examples held in RAM — the oracle the on-disk cache is
    pinned against (and a fine source for small runs / tests)."""

    def __init__(self, kind: str, arrays: Dict[str, List[np.ndarray]],
                 clients: Optional[Sequence[int]] = None,
                 seq_len: Optional[int] = None):
        first = next(iter(arrays.values()))
        self.kind = kind
        self.seq_len = seq_len
        self.num_clients_total = len(first)
        self._arrays = arrays
        self.clients = (tuple(range(self.num_clients_total))
                        if clients is None else tuple(clients))
        self._counts = {m: len(first[m]) for m in range(len(first))}
        self.fields = {
            f: {"dtype": str(rows[0].dtype), "shape": list(rows[0].shape[1:])}
            for f, rows in arrays.items()
        }

    def _with_clients(self, clients):
        return InMemoryClientDataset(self.kind, self._arrays, clients,
                                     seq_len=self.seq_len)

    def _take(self, client, idx):
        return {f: rows[client][idx] for f, rows in self._arrays.items()}


def _mmap_ceiling() -> int:
    """Hard cap on pooled mmaps: half the process's open-file soft limit,
    so the pool can never exhaust file handles even at massive M."""
    try:
        import resource

        soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
        if soft == resource.RLIM_INFINITY:
            return 1 << 16
        return max(_MMAP_CAP, int(soft) // 2)
    except Exception:  # pragma: no cover — non-posix fallback
        return _MMAP_CAP


class CachedClientDataset(ShardableDataset):
    """Read view over a cache directory built by `build_cache` /
    `build_dirichlet_cache`: per-client raw-`.npy` shard files, gathered
    through a bounded pool of mmaps (reads, not synthesis — cheap enough
    for the prefetch thread at massive M). The pool is sized to this
    view's per-round working set (clients x fields, with slack for multi-
    shard gathers) so steady-state rounds never re-`np.load` a shard, and
    clamped to half the open-file rlimit; past that bound reads still
    work, they just reopen (an eviction is ~100us, not a correctness
    issue)."""

    def __init__(self, cache_dir: str,
                 clients: Optional[Sequence[int]] = None):
        self.cache_dir = cache_dir
        self.manifest = _read_manifest(cache_dir)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(
                f"{cache_dir!r} is not a {FORMAT} cache "
                f"(format={self.manifest.get('format')!r})")
        self.kind = self.manifest["kind"]
        self.fields = self.manifest["fields"]
        self.seq_len = self.manifest.get("seq_len")
        self.shard_size = int(self.manifest["shard_size"])
        self.num_clients_total = int(self.manifest["num_clients"])
        counts = self.manifest["num_examples"]
        self._counts = {m: int(n) for m, n in enumerate(counts)}
        self.clients = (tuple(range(self.num_clients_total))
                        if clients is None else tuple(clients))
        self._mmaps: OrderedDict = OrderedDict()
        want = 2 * len(self.clients) * max(len(self.fields), 1)
        self._mmap_cap = min(max(_MMAP_CAP, want), _mmap_ceiling())

    def _with_clients(self, clients):
        return CachedClientDataset(self.cache_dir, clients)

    def _shard_arr(self, client: int, field: str, shard: int) -> np.ndarray:
        key = (client, field, shard)
        arr = self._mmaps.get(key)
        if arr is None:
            arr = np.load(_shard_path(self.cache_dir, client, field, shard),
                          mmap_mode="r")
            self._mmaps[key] = arr
            while len(self._mmaps) > self._mmap_cap:
                self._mmaps.popitem(last=False)
        else:
            self._mmaps.move_to_end(key)
        return arr

    def _take(self, client, idx):
        idx = np.asarray(idx)
        S = self.shard_size
        if self._counts[client] <= S:
            # single-shard client (the usual massive-M layout): one fancy-
            # index gather, no shard bucketing
            return {f: self._shard_arr(client, f, 0)[idx]
                    for f in self.fields}
        shard_ids = idx // S
        out = {}
        for f, spec in self.fields.items():
            rows = np.empty((len(idx),) + tuple(spec["shape"]),
                            np.dtype(spec["dtype"]))
            for s in np.unique(shard_ids):
                sel = shard_ids == s
                rows[sel] = self._shard_arr(client, f, int(s))[idx[sel] - s * S]
            out[f] = rows
        return out


# ---------------------------------------------------------------------------
# building: synthesis sources -> example streams -> shards / memory
# ---------------------------------------------------------------------------


def _source_kind(source) -> str:
    return "lm" if hasattr(source, "chains") else "image"


def _client_example_chunks(source, client: int, total: int,
                           seq_len: Optional[int],
                           seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Yield one client's examples in FIXED `_GEN_CHUNK` pieces.

    The per-client rng stream depends only on (seed, global client) and
    the fixed chunking, so the same rows come out whether the consumer is
    `build_cache` (any shard_size) or `materialize_source`."""
    kind = _source_kind(source)
    if kind == "lm" and seq_len is None:
        raise ValueError("seq_len is required to cache an LM source")
    rng = np.random.default_rng([_BUILD_TAG, int(seed), int(client)])
    done = 0
    while done < total:
        n = min(_GEN_CHUNK, total - done)
        if kind == "lm":
            toks = source.client_tokens(rng, client, n, seq_len)
            yield {"tokens": np.asarray(toks, np.int32)}
        else:
            x, y = source.task_batch(rng, client, n)
            if source.channels == 1:
                x = x[..., 0]
            yield {"image": np.asarray(x, np.float32),
                   "label": np.asarray(y, np.int32)}
        done += n


def _num_source_clients(source) -> int:
    return (source.num_clients if hasattr(source, "chains")
            else source.tasks)


def materialize_source(source, examples_per_client: int, *,
                       seq_len: Optional[int] = None,
                       seed: int = 0) -> InMemoryClientDataset:
    """The in-memory twin of `build_cache`: identical rows, no disk."""
    M = _num_source_clients(source)
    arrays: Dict[str, List[np.ndarray]] = {}
    for m in range(M):
        chunks: Dict[str, List[np.ndarray]] = {}
        for piece in _client_example_chunks(source, m, examples_per_client,
                                            seq_len, seed):
            for f, a in piece.items():
                chunks.setdefault(f, []).append(a)
        for f, parts in chunks.items():
            arrays.setdefault(f, []).append(np.concatenate(parts))
    return InMemoryClientDataset(_source_kind(source), arrays,
                                 seq_len=seq_len)


def _shard_path(cache_dir: str, client: int, field: str, shard: int) -> str:
    return os.path.join(cache_dir, f"client-{client:05d}",
                        f"{field}-{shard:05d}.npy")


def _manifest_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "manifest.json")


def _read_manifest(cache_dir: str) -> dict:
    path = _manifest_path(cache_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no cache manifest at {path} — build one with "
            f"tools/cache_dataset.py (or data.shards.build_cache)")
    with open(path) as f:
        return json.load(f)


def _write_shards(cache_dir: str, client: int,
                  chunks: Iterator[Dict[str, np.ndarray]],
                  shard_size: int) -> Dict[str, dict]:
    """Repack a client's example chunks into shard_size-row .npy files."""
    os.makedirs(os.path.join(cache_dir, f"client-{client:05d}"),
                exist_ok=True)
    pending: Dict[str, List[np.ndarray]] = {}
    counts: Dict[str, int] = {}
    shard_idx: Dict[str, int] = {}
    specs: Dict[str, dict] = {}

    def _flush(field, final=False):
        rows = np.concatenate(pending[field]) if pending[field] else None
        while rows is not None and (len(rows) >= shard_size
                                    or (final and len(rows))):
            piece, rows = rows[:shard_size], rows[shard_size:]
            np.save(_shard_path(cache_dir, client, field, shard_idx[field]),
                    piece)
            shard_idx[field] += 1
        pending[field] = [] if rows is None or not len(rows) else [rows]

    for piece in chunks:
        for f, a in piece.items():
            if f not in pending:
                pending[f], counts[f], shard_idx[f] = [], 0, 0
                specs[f] = {"dtype": str(a.dtype), "shape": list(a.shape[1:])}
            pending[f].append(a)
            counts[f] += len(a)
            _flush(f)
    for f in pending:
        _flush(f, final=True)
    n = set(counts.values())
    assert len(n) == 1, f"fields disagree on row count: {counts}"
    return specs


def _finalize_manifest(cache_dir: str, *, kind: str, num_examples: List[int],
                       shard_size: int, seq_len: Optional[int],
                       fields: Dict[str, dict], build: dict) -> dict:
    manifest = {
        "format": FORMAT,
        "kind": kind,
        "num_clients": len(num_examples),
        "num_examples": [int(n) for n in num_examples],
        "shard_size": int(shard_size),
        "seq_len": seq_len,
        "fields": fields,
        "build": build,
    }
    tmp = _manifest_path(cache_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, _manifest_path(cache_dir))
    return manifest


def _existing_or_conflict(cache_dir: str, build: dict,
                          overwrite: bool) -> Optional[dict]:
    """Build-once: reuse a finished cache with the same build params;
    refuse to silently train on a differently-built one."""
    path = _manifest_path(cache_dir)
    if overwrite or not os.path.exists(path):
        return None
    existing = _read_manifest(cache_dir)
    if existing.get("build") != build:
        raise ValueError(
            f"cache at {cache_dir!r} was built with different parameters:\n"
            f"  existing: {existing.get('build')}\n  requested: {build}\n"
            f"pass overwrite=True (or --overwrite) to rebuild")
    return existing


def build_cache(cache_dir: str, source, examples_per_client: int, *,
                seq_len: Optional[int] = None, shard_size: int = 512,
                seed: int = 0, overwrite: bool = False) -> dict:
    """Materialize `source` into per-client shard files (build-once).

    Returns the manifest. A finished cache with identical build params is
    reused untouched; a parameter mismatch raises (see
    `_existing_or_conflict`)."""
    M = _num_source_clients(source)
    build = {
        "mode": "per-client",
        "source": type(source).__name__,
        "source_params": _source_params(source),
        "examples_per_client": int(examples_per_client),
        "seq_len": seq_len,
        "seed": int(seed),
    }
    existing = _existing_or_conflict(cache_dir, build, overwrite)
    if existing is not None:
        return existing
    os.makedirs(cache_dir, exist_ok=True)
    fields: Dict[str, dict] = {}
    for m in range(M):
        fields = _write_shards(
            cache_dir, m,
            _client_example_chunks(source, m, examples_per_client, seq_len,
                                   seed),
            shard_size)
    return _finalize_manifest(
        cache_dir, kind=_source_kind(source),
        num_examples=[examples_per_client] * M, shard_size=shard_size,
        seq_len=seq_len, fields=fields, build=build)


def _source_params(source) -> dict:
    """JSON-safe provenance for the build-once identity check."""
    import dataclasses

    if dataclasses.is_dataclass(source):
        out = {}
        for f in dataclasses.fields(source):
            v = getattr(source, f.name)
            if isinstance(v, (bool, int, float, str)) or v is None:
                out[f.name] = v
        return out
    return {}


def load_cache(cache_dir: str,
               clients: Optional[Sequence[int]] = None) -> CachedClientDataset:
    return CachedClientDataset(cache_dir, clients)


def cache_fingerprint(cache_dir: str) -> str:
    """sha256 over the manifest and every shard file, in sorted path order
    — two builds with the same parameters must produce the same digest
    (the CI cache-build smoke step pins this)."""
    h = hashlib.sha256()
    root = os.path.abspath(cache_dir)
    paths = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            paths.append(os.path.join(dirpath, name))
    for path in sorted(paths):
        h.update(os.path.relpath(path, root).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Dirichlet partitioning of a labeled corpus (the standard non-IID protocol)
# ---------------------------------------------------------------------------


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Per class c: client proportions ~ Dirichlet(alpha * 1_M); class c's
    (shuffled) examples split by those proportions. Returns per-client
    GLOBAL corpus indices. Every client ends up with >= 1 example (topped
    up from the largest part). Deterministic in (labels, M, alpha, seed).
    """
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    labels = np.asarray(labels)
    rng = np.random.default_rng([_DIRICHLET_TAG, int(seed)])
    parts: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(num_clients, float(alpha)))
        cuts = np.floor(np.cumsum(p)[:-1] * len(idx)).astype(int)
        for m, piece in enumerate(np.split(idx, cuts)):
            parts[m].append(piece)
    out = [np.concatenate(p) if p else np.empty(0, np.int64) for p in parts]
    # no starving clients: the loop indexes every client's store
    for m in range(num_clients):
        while not len(out[m]):
            donor = int(np.argmax([len(o) for o in out]))
            out[m], out[donor] = out[donor][-1:], out[donor][:-1]
    return out


def _partition_chunks(corpus: Dict[str, np.ndarray],
                      idx: np.ndarray) -> Iterator[Dict[str, np.ndarray]]:
    for lo in range(0, len(idx), _GEN_CHUNK):
        piece = idx[lo:lo + _GEN_CHUNK]
        yield {f: np.ascontiguousarray(a[piece]) for f, a in corpus.items()}


def materialize_dirichlet(corpus: Dict[str, np.ndarray], num_clients: int,
                          alpha: float, *, label_field: str = "label",
                          seed: int = 0) -> InMemoryClientDataset:
    parts = dirichlet_partition(corpus[label_field], num_clients, alpha, seed)
    arrays = {f: [np.ascontiguousarray(a[p]) for p in parts]
              for f, a in corpus.items()}
    kind = "lm" if "tokens" in corpus else "image"
    seq = corpus["tokens"].shape[-1] if kind == "lm" else None
    return InMemoryClientDataset(kind, arrays, seq_len=seq)


def build_dirichlet_cache(cache_dir: str, corpus: Dict[str, np.ndarray],
                          num_clients: int, alpha: float, *,
                          label_field: str = "label", shard_size: int = 512,
                          seed: int = 0, overwrite: bool = False) -> dict:
    """Shard a labeled corpus Dirichlet-non-IID across clients (build-once).

    `corpus` is {field: [N, ...]} and must include `label_field`."""
    labels = corpus[label_field]
    build = {
        "mode": "dirichlet",
        "alpha": float(alpha),
        "label_field": label_field,
        "num_clients": int(num_clients),
        "corpus_examples": int(len(labels)),
        "corpus_sha256": _corpus_digest(corpus),
        "seed": int(seed),
    }
    existing = _existing_or_conflict(cache_dir, build, overwrite)
    if existing is not None:
        return existing
    os.makedirs(cache_dir, exist_ok=True)
    parts = dirichlet_partition(labels, num_clients, alpha, seed)
    fields: Dict[str, dict] = {}
    for m, idx in enumerate(parts):
        fields = _write_shards(cache_dir, m, _partition_chunks(corpus, idx),
                               shard_size)
    kind = "lm" if "tokens" in corpus else "image"
    seq = int(corpus["tokens"].shape[-1]) if kind == "lm" else None
    return _finalize_manifest(
        cache_dir, kind=kind, num_examples=[len(p) for p in parts],
        shard_size=shard_size, seq_len=seq, fields=fields, build=build)


def _corpus_digest(corpus: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for f in sorted(corpus):
        a = np.ascontiguousarray(corpus[f])
        h.update(f.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def pooled_corpus(source, total_examples: int, *, seed: int = 0,
                  seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """An IID labeled corpus drawn from a synthesis source — the input a
    Dirichlet split repartitions (labels uniform over classes; the
    heterogeneity then comes from the partition, not the source)."""
    rng = np.random.default_rng([_CORPUS_TAG, int(seed)])
    if _source_kind(source) == "lm":
        if seq_len is None:
            raise ValueError("seq_len is required for an lm corpus")
        toks, labels = [], []
        per = [total_examples // source.num_clients] * source.num_clients
        for m in range(total_examples % source.num_clients):
            per[m] += 1
        for m, n in enumerate(per):
            for lo in range(0, n, _GEN_CHUNK):
                k = min(_GEN_CHUNK, n - lo)
                toks.append(np.asarray(
                    source.client_tokens(rng, m, k, seq_len), np.int32))
                labels.append(np.full(k, m, np.int32))
        return {"tokens": np.concatenate(toks),
                "label": np.concatenate(labels)}
    labels = rng.integers(0, source.num_classes,
                          size=total_examples).astype(np.int64)
    xs = []
    for lo in range(0, total_examples, _GEN_CHUNK):
        x = source.sample_class(rng, labels[lo:lo + _GEN_CHUNK])
        if source.channels == 1:
            x = x[..., 0]
        xs.append(np.asarray(x, np.float32))
    return {"image": np.concatenate(xs), "label": labels.astype(np.int32)}
