"""Shared by tests/test_torch_async_events.py and
tests/test_torch_async_reference.py: the model, the batches, the
heterogeneous deployments and the port's engine on them."""
import functools

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import topology
from repro_torch.core.algorithms import HParams, get_algorithm, list_algorithms
from repro_torch.core.schedule import full_schedule
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.train.events import EventEngine
from repro_torch.train.loop import stage_batch

CFG = get_config("paper-mlp", smoke=True)
MODEL = build_model(CFG)
M = CFG.num_clients
ALL_ALGS = sorted(list_algorithms())
HP = dict(lr=0.1, local_steps=2)
R = 8


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _source():
    return MultiTaskImageSource(num_classes=M, image_size=CFG.image_size,
                                channels=CFG.image_channels, seed=0)


@functools.lru_cache(maxsize=None)
def _batches(spr):
    return tuple(client_batches(_source(), 4 * spr, steps=R, seed=0))


def _topo(kind, module):
    """One client at capability 0.2; 10 Mb/s links; star or a two-server
    multi-server topology syncing every 2 rounds."""
    caps = np.ones(M)
    caps[0] = 0.2
    link = module.mbps(10.0)
    if kind == "star":
        return module.star(M, uplink=link, downlink=link).with_capability(caps)
    return module.multi_server(M, 2, uplink=link, downlink=link,
                               sync_every=2).with_capability(caps)


def _port_engine(alg, kind, state0, **kw):
    a = get_algorithm(alg)
    hp = HParams(**HP)
    return EventEngine(a, MODEL, M, hp, _topo(kind, topology), staleness_decay=0.6,
                       init_state=state0, **kw)


def _pairs(alg, start=0):
    spr = get_algorithm(alg).steps_per_round(HParams(**HP))
    return iter([(stage_batch(b, "cpu"), full_schedule(M, spr))
                 for b in _batches(spr)[start:]])
