"""Serving engine (port of `repro.serve.engine`): batched prefill plus
single-token decode over the split (tower/server) model. Each request
carries a client id and is served by that client's private tower and the
shared server stack. Requests are grouped by client: batch layout
[M, b, ...] like training.

    prefill_step(params, tokens [M,b,S]) -> (logits [M*b,1,V], caches)
    decode_step(params, caches, tokens [M,b,1], pos) -> logits [M*b,1,V]

Caches are updated in place by decode_step. Each client's rows run through
the view of that client's tower (`core.split.client_view`), never a copy.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.split import client_view
from repro_torch.models.registry import Model
from repro_torch.serve.sampling import fold_in, sample
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class ServeCaches(NamedTuple):
    tower: List[PyTree]  # one tower cache per client, batch b
    server: PyTree  # batch M*b


def build_prefill_step(model: Model, num_clients: int, max_len: int) -> Callable:
    def prefill_step(params, tokens):
        """tokens: [M,b,S] -> (last-token logits [M*b,1,V], caches)."""
        hs, tcaches = [], []
        for m in range(num_clients):
            h, tc = model.tower_prefill(client_view(params["towers"], m),
                                        tokens[m], max_len)
            hs.append(h)
            tcaches.append(tc)
        logits, scache = model.server_prefill(params["server"], torch.cat(hs),
                                              max_len)
        return logits, ServeCaches(tower=tcaches, server=scache)

    return prefill_step


def build_decode_step(model: Model, num_clients: int) -> Callable:
    def decode_step(params, caches: ServeCaches, tokens, pos):
        """tokens: [M,b,1] next input token; pos: int. -> logits."""
        hs = [model.tower_decode(client_view(params["towers"], m), tokens[m],
                                 caches.tower[m], pos)
              for m in range(num_clients)]
        return model.server_decode(params["server"], torch.cat(hs),
                                   caches.server, pos)

    return decode_step


def check_params_device(params, device) -> torch.device:
    """The engine's device; raises if a parameter lives elsewhere."""
    dev = resolve_device(device)
    if any(t.device.type != dev.type for t in tree_leaves(params)):
        raise ValueError(f"params must live on {dev.type} to serve there")
    return dev


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ServeEngine:
    """Host-side orchestration: greedy/temperature generation.

    `generate` routes through the continuous-batching scheduler
    (serve/continuous.py), one request per (client, row); its greedy output
    is token-for-token equal to `generate_sequential`, the batched-prefill
    loop kept beside it."""

    def __init__(self, model: Model, params, num_clients: int, max_len: int,
                 sample_seed: int = 0, device="cuda"):
        self.device = check_params_device(params, device)
        self.model = model
        self.params = params
        self.M = num_clients
        self.max_len = max_len
        # engine-default sampling stream: requests submitted without their
        # own key sample from fold_in(sample_seed, request_id)
        self.sample_seed = sample_seed
        self._prefill = build_prefill_step(model, num_clients, max_len)
        self._decode = build_decode_step(model, num_clients)
        self._cont = {}  # (b, S) -> ContinuousEngine

    @torch.no_grad()
    def generate(self, inputs, new_tokens: int, temperature: float = 0.0,
                 rng: Optional[int] = None) -> torch.Tensor:
        """inputs: {tokens: [M,b,S]}; returns int32 [M, b, new_tokens].
        Families without chunked prefill (no tower_extend) and ring KV
        caches go through generate_sequential, as in the reference."""
        if self.model.tower_extend is None or self.model.cfg.decode_long_window:
            return self.generate_sequential(inputs, new_tokens, temperature, rng)
        from repro_torch.serve.continuous import ContinuousEngine, Request

        M = self.M
        prompt = _host(inputs["tokens"])
        b, S = prompt.shape[1], prompt.shape[2]
        key = (b, S)
        if key not in self._cont:
            # chunk = prompt length: whole-prompt extend, one slot per row
            self._cont[key] = ContinuousEngine(
                self.model, self.params, M, self.max_len, slots=M * b,
                chunk=S, seed=self.sample_seed, device=self.device)
        eng = self._cont[key]
        for m in range(M):
            for j in range(b):
                rid = m * b + j
                rkey = None
                if temperature > 0.0 and rng is not None:
                    rkey = fold_in(rng, rid)
                eng.submit(Request(id=rid, client=m, tokens=prompt[m, j],
                                   new_tokens=new_tokens,
                                   temperature=temperature, key=rkey))
        res = eng.run()
        out = np.stack([res[m * b + j] for m in range(M) for j in range(b)])
        return torch.as_tensor(out.reshape(M, b, new_tokens), dtype=torch.int32)

    @torch.no_grad()
    def generate_sequential(self, inputs, new_tokens: int,
                            temperature: float = 0.0,
                            rng: Optional[int] = None) -> torch.Tensor:
        """Batched-prefill + lockstep-decode loop (all rows enter and leave
        together). inputs: {tokens: [M,b,S]}; returns int32 [M, b, new]."""
        M = self.M
        tokens = torch.as_tensor(_host(inputs["tokens"]), dtype=torch.int64,
                                 device=self.device)
        b, S = tokens.shape[1], tokens.shape[2]
        logits, caches = self._prefill(self.params, tokens)
        out = []
        tok = self._sample(logits, temperature, rng, 0).reshape(M, b, 1)
        for t in range(new_tokens):
            out.append(tok)
            if t == new_tokens - 1:
                break
            logits = self._decode(self.params, caches, tok.long(), S + t)
            tok = self._sample(logits, temperature, rng, t + 1).reshape(M, b, 1)
        return torch.cat(out, dim=-1).cpu()

    @staticmethod
    def _sample(logits, temperature, rng, step):
        logits = logits[:, -1, :]
        if temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # fold the row index into the key: rows sample independently
        rows = torch.arange(logits.shape[0], device=logits.device)
        return sample(logits, temperature, fold_in(fold_in(rng, step), rows))
