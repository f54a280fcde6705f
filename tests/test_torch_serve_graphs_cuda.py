"""The engines' compiled steps on the card: the CUDA graphs that
`serve/graphs.py` captures against the same steps run eagerly. Marked
`cuda`: each test skips without a card. The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_serve_graphs_cuda.py

  * Per family, on the smoke configs in f32 (TF32 off): the continuous
    engine (dense, ssm, hybrid, moe; 7 mixed-length requests over 2 slots,
    chunk 4) and the sequential engine (the VLM, whisper, ring caches) give
    the same tokens replayed as eager, token for token, and the same
    logits within 1e-6 of their scale; the launch counts that K3 and K4
    keep on the card, the Python counters (each replay adds its step's)
    and the MoE tally come out equal; the continuous engine captured
    M + 1 graphs and no more.
  * Every step runs under torch.cuda.set_sync_debug_mode("error"): none
    waits on the card.
  * A step that syncs makes its capture raise; nothing falls back.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.counts import REGISTERED
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch.serve import init_params, seeded_inputs
from repro_torch.models import build_model, layers, moe
from repro_torch.serve import graphs
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.engine import ServeEngine

CONT_ARCHS = ["gemma3-12b", "mamba2-130m", "zamba2-7b", "deepseek-moe-16b"]
RING = dict(sliding_window=8, decode_long_window=8, attn_pattern=("swa",),
            num_layers=2, split_layers=1)
SEQ_CASES = {"vlm": ("llama-3.2-vision-11b", {}), "whisper": ("whisper-tiny", {}),
             "ring": ("gemma3-12b", RING)}
LENS = [3, 9, 5, 12, 4, 7, 2]
NEW = [5, 3, 6, 2, 4, 5, 3]
MAX_LEN = 20
LOGITS_TOL = 1e-6  # of max(1, max |logit|)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the steps are captured as CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(a, b):
    scale = max(1.0, b.abs().max().item())
    assert (a - b).abs().max().item() <= LOGITS_TOL * scale


def _counts():
    """Every counter: the Python ones by (function, attribute), K4's and
    K3's launches on the card by (kernel, mode or path)."""
    out = dict(zip(REGISTERED, graphs.read_counts()))
    for fn in (flash_decode, ssd_scan):
        out.update({(fn, k): n for k, n in fn.counts.read().items()})
    return out


def _since(before):
    return {k: n - before.get(k, 0) for k, n in _counts().items()}


def _launches(c, fn):
    return sum(c[(fn, k)] for k in fn.counts.keys)


def _serve_continuous(model, params, cfg, use_graphs, sync_check=False):
    """Tokens, each decode step's logits, counters and tally of one run."""
    M = cfg.num_clients
    moe.moe_forward.tally = tally = torch.zeros(2, dtype=torch.int64, device="cuda")
    try:
        eng = ContinuousEngine(model, params, M, MAX_LEN, slots=2, chunk=4,
                               device="cuda", graphs=use_graphs)
        rng = np.random.default_rng(21)
        for i, (L, n) in enumerate(zip(LENS, NEW)):
            eng.submit(Request(id=i, client=i % M, new_tokens=n,
                               tokens=rng.integers(0, cfg.vocab_size, size=L),
                               temperature=0.8 if i == 3 else 0.0))
        before = _counts()
        logits = []
        mode = "error" if sync_check else "default"
        while True:
            torch.cuda.set_sync_debug_mode(mode)
            try:
                issued = eng._issue_chunk()
                decoded = eng._decode_once()
                if decoded is not None:
                    logits.append(decoded.clone())
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if not issued and decoded is None:
                break
        res = eng.run()
        counts = _since(before)
    finally:
        moe.moe_forward.tally = None
    return eng, res, logits, counts, tally.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CONT_ARCHS)
def test_continuous_replay_equals_eager(arch):
    _card()
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = init_params(model, cfg.num_clients, 7, "cuda")
    eager = _serve_continuous(model, params, cfg, False, sync_check=True)
    replay = _serve_continuous(model, params, cfg, True)
    eng = replay[0]
    assert eng.stats["captures"] == eng.stats["steps"] == cfg.num_clients + 1
    assert eng.graphs.pool_bytes() > 0 and eager[0].stats["captures"] == 0
    for i in range(len(LENS)):
        np.testing.assert_array_equal(replay[1][i], eager[1][i])
    assert len(replay[2]) == len(eager[2]) > 0
    for a, b in zip(replay[2], eager[2]):
        _close(a, b)
    assert replay[3] == eager[3] and replay[4] == eager[4]
    assert eng.logits_finite()
    # the launches counted on the card say the kernels ran: K4 on every
    # decode attention, K3 on every scanning layer of an extend chunk
    c = replay[3]
    assert _launches(c, flash_decode) == c[(layers.attn_decode, "calls")]
    if cfg.family in ("ssm", "hybrid"):
        assert _launches(c, ssd_scan) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_sequential_replay_equals_eager(name):
    _card()
    arch, upd = SEQ_CASES[name]
    cfg = get_config(arch, smoke=True).with_updates(**upd)
    model = build_model(cfg)
    M, L, n = cfg.num_clients, 12, 8
    params = init_params(model, M, 4, "cuda")
    inputs = seeded_inputs(cfg, M, 2, L, 11)
    out = {}
    for use_graphs in (False, True):
        eng = ServeEngine(model, params, M, L + n, device="cuda", graphs=use_graphs)
        with torch.no_grad():
            staged = {k: torch.as_tensor(v, device="cuda") for k, v in inputs.items()}
            staged["tokens"] = staged["tokens"].long()
            logits, caches = eng._prefill(params, staged)
            tok = eng._sample(logits, 0.0, None, 0).reshape(M, 2, 1)
            buf = eng.load_caches(caches, 2, L)
            before = _counts()
            if not use_graphs:
                torch.cuda.set_sync_debug_mode("error")
            try:
                toks = eng.decode(buf, tok, n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counts = _since(before)
        again = eng.generate_sequential(inputs, n)
        assert torch.equal(again, toks.cpu())
        assert eng.graphs.steps == 1 and eng.graphs.captures == int(use_graphs)
        out[use_graphs] = (toks.cpu(), counts)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    c = out[True][1]
    k4 = _launches(c, flash_decode)
    assert k4 == c[(layers.attn_decode, "calls")] > 0
    if name == "ring":
        assert c[(flash_decode, "ring")] == k4
    else:
        assert c[(flash_decode, "cross")] > 0


@pytest.mark.cuda
def test_sequential_logits_replay_equal_eager():
    """The decode logits of the replayed step against the eager one, step
    by step, on the VLM (cross decodes) fed the same tokens."""
    _card()
    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    model = build_model(cfg)
    M, L, n = cfg.num_clients, 9, 5
    params = init_params(model, M, 4, "cuda")
    inputs = seeded_inputs(cfg, M, 2, L, 3)
    staged = {k: torch.as_tensor(v, device="cuda") for k, v in inputs.items()}
    staged["tokens"] = staged["tokens"].long()
    eager = ServeEngine(model, params, M, L + n, device="cuda", graphs=False)
    replay = ServeEngine(model, params, M, L + n, device="cuda")
    with torch.no_grad():
        _, caches = eager._prefill(params, staged)
        tok = torch.zeros((M, 2, 1), dtype=torch.int32, device="cuda")
        bufs = [e.load_caches(caches, 2, L) for e in (eager, replay)]
        for t in range(n):
            tok = tok + 1
            got = []
            for buf in bufs:
                buf.tok.copy_(tok)
                got.append(buf.step.run().clone())
            _close(got[1], got[0])
        assert int(bufs[1].pos) == L + n


@pytest.mark.cuda
def test_a_step_that_syncs_cannot_be_captured():
    dev = _card()
    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        graphs.StepGraphs(dev).step(lambda: x * x.sum().item())
    # the card still works, and a step that does not sync captures (in a
    # new pool: the failed capture leaves its engine's pool unusable)
    y = graphs.StepGraphs(dev).step(lambda: x * 2)
    x.fill_(3.0)
    assert y.run().tolist() == [6.0] * 4
