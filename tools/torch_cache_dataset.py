"""Offline client-cache builder on the PyTorch port (the twin of
tools/cache_dataset.py, built on `repro_torch.data.shards`): the same
flags, the same files byte for byte, the same fingerprint.

Materializes per-client shard files from a synthesis source or as a
Dirichlet non-IID partition of a labeled corpus, so training runs
(`repro_torch.launch.train --data cached --cache-dir D`) read deterministic,
resharding-invariant shards instead of re-synthesizing every round's
batch on the host. Builds are build-once and byte-stable: re-running
with the same parameters touches nothing, and two fresh builds produce
identical bytes (`--fingerprint` prints the digest CI pins).

Usage (PYTHONPATH=src):
    # per-client streams from the paper's synthetic image source
    python tools/torch_cache_dataset.py --cache-dir /tmp/cache --kind image \
        --num-clients 10 --examples-per-client 1024 --alpha 0.0

    # per-client Markov LM streams
    python tools/torch_cache_dataset.py --cache-dir /tmp/lmcache --kind lm \
        --num-clients 8 --examples-per-client 512 --seq-len 256

    # Dirichlet split of an on-disk corpus (.npz with 'label' + data
    # fields), the FedProx/ParallelSFL heterogeneity protocol
    python tools/torch_cache_dataset.py --cache-dir /tmp/dircache \
        --corpus corpus.npz --num-clients 10 --dirichlet-alpha 0.3

    # Dirichlet split of a pooled SYNTHETIC corpus (no file needed)
    python tools/torch_cache_dataset.py --cache-dir /tmp/dircache --kind image \
        --num-clients 10 --examples-per-client 512 --dirichlet-alpha 0.3
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from repro_torch.data import shards  # noqa: E402
from repro_torch.data.lm import MultiTaskLMSource  # noqa: E402
from repro_torch.data.synthetic import MultiTaskImageSource  # noqa: E402


def _make_source(args):
    if args.kind == "lm":
        return MultiTaskLMSource(vocab_size=args.vocab_size,
                                 num_clients=args.num_clients,
                                 beta=args.beta, seed=args.seed)
    return MultiTaskImageSource(
        num_classes=args.num_classes,
        num_tasks=(None if args.num_clients == args.num_classes
                   else args.num_clients),
        image_size=args.image_size, channels=args.channels,
        alpha=args.alpha, noise_sigma=args.noise_sigma, seed=args.seed)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="build a per-client shard cache (data/shards.py)")
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--kind", default="image", choices=["image", "lm"],
                    help="synthesis source kind (ignored with --corpus)")
    ap.add_argument("--num-clients", type=int, default=10)
    ap.add_argument("--examples-per-client", type=int, default=512)
    ap.add_argument("--shard-size", type=int, default=512,
                    help="rows per on-disk shard file (iteration is "
                         "invariant to this — pick for file-size comfort)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overwrite", action="store_true",
                    help="rebuild even if a cache with different build "
                         "parameters already exists at --cache-dir")
    ap.add_argument("--dirichlet-alpha", type=float, default=None,
                    help="build a Dirichlet(alpha) non-IID partition of a "
                         "corpus (--corpus, or a pooled synthetic corpus) "
                         "instead of per-client streams")
    ap.add_argument("--corpus", default=None,
                    help=".npz with a 'label' field plus data fields to "
                         "Dirichlet-partition (requires --dirichlet-alpha)")
    # image-source knobs
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=28)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="paper Eq. 13 label-mixing heterogeneity")
    ap.add_argument("--noise-sigma", type=float, default=0.0)
    # lm-source knobs
    ap.add_argument("--vocab-size", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--beta", type=float, default=1.0,
                    help="lm chain heterogeneity (1 = disjoint chains)")
    ap.add_argument("--fingerprint", action="store_true",
                    help="print the cache's sha256 fingerprint (byte-"
                         "stability pin) after building")
    args = ap.parse_args(argv)

    if args.corpus is not None:
        if args.dirichlet_alpha is None:
            raise SystemExit("--corpus requires --dirichlet-alpha")
        with np.load(args.corpus) as z:
            corpus = {k: np.asarray(z[k]) for k in z.files}
        if "label" not in corpus:
            raise SystemExit(
                f"{args.corpus!r} has no 'label' field (found: "
                f"{sorted(corpus)})")
        manifest = shards.build_dirichlet_cache(
            args.cache_dir, corpus, args.num_clients, args.dirichlet_alpha,
            shard_size=args.shard_size, seed=args.seed,
            overwrite=args.overwrite)
    else:
        src = _make_source(args)
        seq = args.seq_len if args.kind == "lm" else None
        if args.dirichlet_alpha is not None:
            corpus = shards.pooled_corpus(
                src, args.num_clients * args.examples_per_client,
                seed=args.seed, seq_len=seq)
            manifest = shards.build_dirichlet_cache(
                args.cache_dir, corpus, args.num_clients,
                args.dirichlet_alpha, shard_size=args.shard_size,
                seed=args.seed, overwrite=args.overwrite)
        else:
            manifest = shards.build_cache(
                args.cache_dir, src, args.examples_per_client, seq_len=seq,
                shard_size=args.shard_size, seed=args.seed,
                overwrite=args.overwrite)
    total = sum(manifest["num_examples"])
    print(f"cache at {args.cache_dir}: kind={manifest['kind']} "
          f"clients={manifest['num_clients']} examples={total} "
          f"shard_size={manifest['shard_size']}")
    if args.fingerprint:
        print(f"fingerprint {shards.cache_fingerprint(args.cache_dir)}")
    return manifest


if __name__ == "__main__":
    main()
