"""Serving engine (port of `repro.serve.engine`): batched prefill plus
single-token decode over the split (tower/server) model. Each request
carries a client id and is served by that client's private tower and the
shared server stack. Requests are grouped by client: batch layout
[M, b, ...] like training.

    prefill_step(params, inputs) -> (logits [M*b,1,V], caches)
    decode_step(params, caches, tokens [M,b,1], pos) -> logits [M*b,1,V]

`pos` is an int or a device scalar. `generate_sequential` runs the decode
step as a CUDA graph (`serve/graphs.py`), as the reference jits it with a
traced `pos`: one graph per batch shape, captured on the first call of
that shape over static buffers (the caches, the token, pos). Each call
copies its prefill's caches into them once (`load_caches`) and drops its
own, so between calls the engine holds one set of caches per batch shape
it has served, and a call holds two only from its prefill to that copy.
pos is set by the host once and advanced inside the graph, the token
written by the host's sampling (which stays outside the graph). A second
call of the shape captures nothing. Prefill stays eager, as the
reference traces it anew per prompt shape.

`inputs` is {"tokens": [M,b,S]} plus the VLM's "vis" or the
encoder-decoder's "frames" ([M,b,...]). The caches hold, beside the
tower and server caches, the `extras` that decode reads again (the VLM's
projected vision features). Caches are updated in place by decode_step.
Each client's rows run through the view of that client's tower
(`core.split.client_view`), never a copy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.split import client_view
from repro_torch.models.registry import Model
from repro_torch.serve.graphs import Step, StepGraphs
from repro_torch.serve.sampling import fold_in, sample
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


class ServeCaches(NamedTuple):
    tower: List[PyTree]  # one tower cache per client, batch b
    server: PyTree  # batch M*b
    extras: Dict[str, torch.Tensor]  # uploads decode reads again (vis_proj)


class _DecodeBuffers(NamedTuple):
    """One batch shape's static decode inputs and its step."""
    caches: ServeCaches
    tok: torch.Tensor  # [M, b, 1] int64
    pos: torch.Tensor  # () int64
    step: Step


def _cat(parts: List[dict]) -> dict:
    """Per-client smashed dicts -> one dict over the M*b rows."""
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def build_prefill_step(model: Model, num_clients: int, max_len: int) -> Callable:
    def prefill_step(params, inputs):
        """inputs: {tokens: [M,b,S], vis / frames: [M,b,...]} on the
        engine's device -> (last-token logits [M*b,1,V], caches)."""
        smashed, tcaches = [], []
        for m in range(num_clients):
            sm, tc = model.tower_prefill(client_view(params["towers"], m),
                                         {k: v[m] for k, v in inputs.items()},
                                         max_len)
            smashed.append(sm)
            tcaches.append(tc)
        flat = _cat(smashed)
        logits, scache = model.server_prefill(params["server"], flat, max_len)
        extras = {k: v for k, v in flat.items() if k not in ("h", "tokens")}
        return logits, ServeCaches(tower=tcaches, server=scache, extras=extras)

    return prefill_step


def build_decode_step(model: Model, num_clients: int) -> Callable:
    def decode_step(params, caches: ServeCaches, tokens, pos):
        """tokens: [M,b,1] next input token; pos: int or device scalar.
        -> logits."""
        b = tokens.shape[1]
        smashed = []
        for m in range(num_clients):
            inputs_t = {"tokens": tokens[m],
                        **{k: v[m * b:(m + 1) * b] for k, v in caches.extras.items()}}
            smashed.append(model.tower_decode(client_view(params["towers"], m),
                                              inputs_t, caches.tower[m], pos))
        return model.server_decode(params["server"], _cat(smashed),
                                   caches.server, pos)

    return decode_step


def stage_inputs(inputs, device) -> Dict[str, torch.Tensor]:
    """A request batch {tokens [M,b,S], vis / frames [M,b,...]} (numpy
    arrays or tensors) as tensors on `device`: tokens int64, the rest as
    given."""
    return {k: torch.as_tensor(v, device=device).long() if k == "tokens"
            else torch.as_tensor(v, device=device) for k, v in inputs.items()}


def check_params_device(params, device) -> torch.device:
    """The engine's device; raises if a parameter lives elsewhere."""
    dev = resolve_device(device)
    if any(t.device.type != dev.type for t in tree_leaves(params)):
        raise ValueError(f"params must live on {dev.type} to serve there")
    return dev


def _leaves(caches: ServeCaches) -> list:
    return tree_leaves([caches.tower, caches.server, caches.extras])


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ServeEngine:
    """Host-side orchestration: greedy/temperature generation.

    `generate` routes through the continuous-batching scheduler
    (serve/continuous.py), one request per (client, row); its greedy output
    is token-for-token equal to `generate_sequential`, the batched-prefill
    loop kept beside it."""

    def __init__(self, model: Model, params, num_clients: int, max_len: int,
                 sample_seed: int = 0, device="cuda", graphs: bool = True):
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
        self.graphs = StepGraphs(self.device, graphs)  # the sequential steps
        self._buffers: Dict[tuple, _DecodeBuffers] = {}  # by batch shape
        self._cont = {}  # (b, S) -> ContinuousEngine

    @torch.no_grad()
    def generate(self, inputs, new_tokens: int, temperature: float = 0.0,
                 rng: Optional[int] = None) -> torch.Tensor:
        """inputs: {tokens: [M,b,S], ...}; returns int32 [M, b, new_tokens].
        Families without chunked prefill (no tower_extend: vlm, encdec)
        and ring KV caches go through generate_sequential, as in the
        reference."""
        from repro_torch.serve.continuous import (ContinuousEngine, Request,
                                                  continuous_refusal)

        if continuous_refusal(self.model):
            return self.generate_sequential(inputs, new_tokens, temperature, rng)

        M = self.M
        prompt = _host(inputs["tokens"])
        b, S = prompt.shape[1], prompt.shape[2]
        key = (b, S)
        if key not in self._cont:
            # chunk = prompt length: whole-prompt extend, one slot per row
            self._cont[key] = ContinuousEngine(
                self.model, self.params, M, self.max_len, slots=M * b,
                chunk=S, seed=self.sample_seed, device=self.device,
                graphs=self.graphs.enabled)
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
        together). inputs: {tokens: [M,b,S], vis / frames: [M,b,...]};
        returns int32 [M, b, new]."""
        M = self.M
        inputs = stage_inputs(inputs, self.device)
        b, S = inputs["tokens"].shape[1], inputs["tokens"].shape[2]
        logits, caches = self._prefill(self.params, inputs)
        tok = self._sample(logits, temperature, rng, 0).reshape(M, b, 1)
        if new_tokens <= 1:
            return tok.cpu()
        buf = self.load_caches(caches, b, S)
        del caches  # the static caches are the only copy from here on
        return self.decode(buf, tok, new_tokens, temperature, rng).cpu()

    @torch.no_grad()
    def load_caches(self, caches: ServeCaches, b: int,
                    start: int) -> _DecodeBuffers:
        """The batch shape's static decode buffers (its step captured over
        them on the shape's first call), filled from a prefill's caches by
        one copy, with pos = start, the first position to decode. The
        caller drops the prefill's caches after this."""
        buf = self._decode_buffers(caches, b)
        for dst, src in zip(_leaves(buf.caches), _leaves(caches)):
            dst.copy_(src)
        buf.pos.fill_(start)
        return buf

    @torch.no_grad()
    def decode(self, buf: _DecodeBuffers, tok, new_tokens: int,
               temperature: float = 0.0,
               rng: Optional[int] = None) -> torch.Tensor:
        """The prefill's first token tok [M,b,1] and new_tokens - 1 decode
        steps from `buf` (`load_caches`), each a replay of its graph.
        Returns int32 [M, b, new_tokens] on the engine's device."""
        out = [tok]
        for t in range(1, new_tokens):
            buf.tok.copy_(tok)
            logits = buf.step.run()
            tok = self._sample(logits, temperature, rng, t).reshape(tok.shape)
            out.append(tok)
        return torch.cat(out, dim=-1)

    def _decode_buffers(self, caches: ServeCaches, b: int) -> _DecodeBuffers:
        """The static decode inputs of this batch shape and its step,
        captured over them (zeros) on the shape's first call."""
        key = (b,) + tuple((tuple(x.shape), x.dtype) for x in _leaves(caches))
        buf = self._buffers.get(key)
        if buf is None:
            static = ServeCaches(*(tree_map(torch.zeros_like, part)
                                   for part in caches))
            tok = torch.zeros((self.M, b, 1), dtype=torch.int64, device=self.device)
            pos = torch.zeros((), dtype=torch.int64, device=self.device)
            # the step does not hold the engine (no reference cycle: an
            # engine no caller holds is freed at once)
            decode, params = self._decode, self.params

            @torch.no_grad()
            def step():
                logits = decode(params, static, tok, pos)
                pos.add_(1)
                return logits

            buf = self._buffers[key] = _DecodeBuffers(static, tok, pos,
                                                      self.graphs.step(step))
        return buf

    @staticmethod
    def _sample(logits, temperature, rng, step):
        logits = logits[:, -1, :]
        if temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # fold the row index into the key: rows sample independently
        rows = torch.arange(logits.shape[0], device=logits.device)
        return sample(logits, temperature, fold_in(fold_in(rng, step), rows))
