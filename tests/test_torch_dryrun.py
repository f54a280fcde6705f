"""The port's dry-run on the meta device (`repro_torch.launch.dryrun`), on
the CPU:

  * each kernel's cost model gives the FLOPs and bytes of the formulas
    `chip_smoke.py`'s k1-k4 phases wrote inline before, for those phases'
    shapes (the bounds they print rest on these functions now);
  * the meta branch of each wrapper: outputs of the launch's shapes and
    dtypes, one call tallied in `kernels.counts.META`, nothing run; CPU
    tensors still take the plain version and tally nothing;
  * the dry-run's FLOPs for paper-mlp equal the analytic count, and its
    K2 / K3 / K1 launches for a train round equal `launches_per_round`
    (the formula `chip_smoke.py` holds the card's counts to) on four smoke
    LMs;
  * `utils.collectives.CollectiveStats.summary()` prints what the
    reference's `repro.utils.hlo.CollectiveStats` prints for the same
    counts;
  * `utils.jit_cache.enable_compilation_cache` round-trips a directory;
  * the CLI runs one program to its summary line and exits 0.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro.utils.hlo import CollectiveStats as RefStats
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.counts import META
from repro_torch.kernels.flash_attention.ops import (attention_cost, flash_attention,
                                                     visible_pairs)
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.flash_decode.ops import decode_cost, flash_decode, split_plan
from repro_torch.kernels.flash_decode.ref import decode_reference
from repro_torch.kernels.mtsl_update.ops import (mtsl_update_, mtsl_update_multi_,
                                                 update_cost)
from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
from repro_torch.kernels.ssd_scan.ops import scan_cost, scan_plan, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_reference
from repro_torch.launch import dryrun
from repro_torch.launch.hardware import bound_ms
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.utils.collectives import CollectiveStats
from repro_torch.utils.jit_cache import ENV_VAR, enable_compilation_cache

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the k1-k4 phases' cases; stdlib imports only)

META_DEV = torch.device("meta")


def _elt(dt):
    return torch.empty((), dtype=getattr(torch, dt)).element_size()


# ---------------------------------------------------------------------------
# cost models against the k1-k4 phases' formulas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", chip_smoke.K2_CASES, ids=lambda c: c[0])
def test_attention_cost_is_the_k2_phase_formula(case):
    _, B, Sq, Sk, causal, Hq, Hkv, D, window, dt = case
    elt = _elt(dt)
    if not causal:
        pairs = Sq * Sk
    elif not window or window >= Sq:
        pairs = Sq * (Sq + 1) // 2
    else:
        pairs = window * (window + 1) // 2 + (Sq - window) * window
    cost = attention_cost(B, Sq, Sk, Hq, Hkv, D, causal, window, elt)
    assert visible_pairs(Sq, Sk, causal, window) == pairs
    assert cost.bytes == 2 * (B * Sq * Hq * D + B * Sk * Hkv * D) * elt
    assert cost.flops == 4 * D * Hq * B * pairs
    assert cost.workspace_bytes == 0


@pytest.mark.parametrize("case", chip_smoke.K3_CASES, ids=lambda c: c[0])
def test_scan_cost_is_the_k3_phase_formula(case):
    _, B, L, H, P, N, chunk, dt, with_state = case
    elt, dtype = _elt(dt), getattr(torch, dt)
    cost = scan_cost(B, L, H, P, N, chunk, dtype, with_state)
    assert cost.bytes == ((2 * B * L * H * P + 2 * B * L * N) * elt
                          + 4 * (B * L * H + H) + 4 * B * H * P * N * (2 if with_state else 1))
    assert cost.flops == B * H * 2 * L * (chunk * N + chunk * P // 2 + 2 * P * N)
    ring = scan_plan(B, L, H, P, N, dtype)["ring"]
    assert cost.workspace_bytes == (0 if ring is None else 4 * torch.Size(ring).numel())


@pytest.mark.parametrize("case", chip_smoke.K4_CASES, ids=lambda c: c[0])
def test_decode_cost_is_the_kernel_phase_formula(case):
    _, B, cap, Hq, Hkv, D, window, dt, (lo, hi), _ = case
    elt, dtype = _elt(dt), getattr(torch, dt)
    for visible in (B * lo, B * (hi - 1), B * cap):  # the phase counts its mask
        cost = decode_cost(B, cap, Hq, Hkv, D, visible, dtype)
        assert cost.bytes == (2 * visible * Hkv * D + 2 * B * Hq * D) * elt + 2 * 4 * B
        assert cost.flops == 4 * visible * Hq * D
    want = (4 * torch.Size(split_plan(B, Hkv, cap, Hq // Hkv, D)["partials"]).numel()
            if dt == "bfloat16" else 0)
    assert cost.workspace_bytes == want


@pytest.mark.parametrize("case", chip_smoke.K1_FLAT_CASES, ids=lambda c: c[0])
def test_update_cost_is_the_k1_phase_formula(case):
    _, shape, _, dt = case
    n, elt = torch.Size(shape).numel(), _elt(dt)
    cost = update_cost(n, elt)
    assert cost.bytes == 3 * n * elt and cost.flops == 2 * n
    # the bound the phase prints: bytes over the memory rate, in ms
    assert bound_ms(cost.flops, cost.bytes, dt) == (3 * n * elt / 3.35e12 * 1e3, "bytes")


# ---------------------------------------------------------------------------
# the wrappers' meta branch
# ---------------------------------------------------------------------------


def _attn_inputs(device, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=g, dtype=dtype)
    k = torch.randn(2, 16, 2, 8, generator=g, dtype=dtype)
    v = torch.randn(2, 16, 2, 8, generator=g, dtype=dtype)
    return [t.to(device) for t in (q, k, v)]


def _scan_inputs(device, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    B, L, H, P, N = 1, 32, 2, 16, 16
    x = torch.randn(B, L, H, P, generator=g).to(dtype)
    dt = torch.rand(B, L, H, generator=g) * 0.1 + 0.01
    A = -torch.rand(H, generator=g) - 0.5
    Bm, Cm = (torch.randn(B, L, N, generator=g).to(dtype) for _ in range(2))
    return [t.to(device) for t in (x, dt, A, Bm, Cm)]


def test_meta_calls_allocate_outputs_and_tally_one_launch_each():
    META.reset()
    q, k, v = _attn_inputs(META_DEV, torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    flash_attention(q, k, v, causal=False, cross=True)
    x, dt, A, Bm, Cm = _scan_inputs(META_DEV, torch.bfloat16)
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    assert y.is_meta and y.shape == x.shape and st.shape == (1, 2, 16, 16)
    assert st.dtype == torch.float32
    cache = torch.empty(2, 96, 2, 8, dtype=torch.bfloat16, device=META_DEV)
    qd = torch.empty(2, 1, 4, 8, dtype=torch.bfloat16, device=META_DEV)
    o = flash_decode(qd, cache, cache, kv_valid=96, mode="ring")
    assert o.is_meta and o.shape == qd.shape
    p, p5 = torch.empty(4, 3, device=META_DEV), torch.empty(5, device=META_DEV)
    mtsl_update_multi_([p, p5], [p, p5], [0.1, 0.1])
    assert mtsl_update_(p, p, 0.1) is p
    got = META.by_kernel
    assert got["flash_attention"]["launches"] == 2
    assert got["flash_attention"]["by_key"] == {"causal": 1, "cross": 1}
    assert got["flash_attention"]["flops"] == (
        attention_cost(2, 16, 16, 4, 2, 8, True, 0, 2).flops
        + attention_cost(2, 16, 16, 4, 2, 8, False, 0, 2).flops)
    assert got["ssd_scan"]["launches"] == 1 and got["ssd_scan"]["by_key"] == {"tc": 1}
    assert got["flash_decode"]["by_key"] == {"ring": 1}
    assert got["flash_decode"]["flops"] == decode_cost(2, 96, 4, 2, 8, 2 * 96,
                                                       torch.bfloat16).flops
    assert got["mtsl_update_multi_"]["launches"] == 1
    assert got["mtsl_update_multi_"]["leaves"] == 2
    assert got["mtsl_update_"]["launches"] == 1
    META.reset()


def test_meta_backward_recomputes_through_the_plain_versions():
    """K2's and K3's backwards differentiate the plain versions, on meta as
    on the card: the gradients have the inputs' shapes, and the forward
    is the only launch tallied."""
    META.reset()
    q, k, v = (t.requires_grad_() for t in _attn_inputs(META_DEV))
    flash_attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    x, dt, A, Bm, Cm = (t.requires_grad_() for t in _scan_inputs(META_DEV))
    y, _ = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y.sum().backward()
    assert x.grad.shape == x.shape and A.grad.shape == A.shape
    assert META.launches("flash_attention") == 1 and META.launches("ssd_scan") == 1
    META.reset()


def test_cpu_tensors_take_the_plain_versions_and_tally_nothing():
    META.reset()
    q, k, v = _attn_inputs("cpu")
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       mha_reference(q, k, v, causal=True))
    x, dt, A, Bm, Cm = _scan_inputs("cpu")
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    yr, sr = ssd_reference(x, dt, A, Bm, Cm, chunk=16)
    assert torch.equal(y, yr) and torch.equal(st, sr)
    qd = q[:, :1]
    assert torch.equal(flash_decode(qd, k, v, kv_valid=9),
                       decode_reference(qd, k, v, kv_valid=9))
    p, g = torch.randn(6, 4), torch.randn(6, 4)
    want = mtsl_update_reference(p, g, 0.5)
    assert torch.equal(mtsl_update_(p.clone(), g, 0.5), want)
    assert torch.equal(mtsl_update_multi_([p.clone()], [g], [0.5])[0], want)
    assert META.by_kernel == {}
    assert flash_attention.launches == 0 and mtsl_update_multi_.launches == 0


# ---------------------------------------------------------------------------
# the dry-run's counts
# ---------------------------------------------------------------------------


def test_paper_mlp_flops_equal_the_analytic_count():
    """One mtsl round of paper-mlp (M = 10, b = 8): every weight's product
    forward, its weight gradient and, past the first layer, its input
    gradient (2 N in out each), and K1's multiply and subtract per
    parameter."""
    cfg = get_config("paper-mlp")
    M, b = cfg.num_clients, 8
    r = dryrun.run_program(build_model(cfg), "train", M, b, 0, optimizer=sgd(0.1),
                           lr=0.1, device="cpu")
    layers = list(zip(cfg.mlp_dims, cfg.mlp_dims[1:]))
    N = M * b
    products = sum(2 * N * i * o * (2 if k == 0 else 3) for k, (i, o) in enumerate(layers))
    params = sum((i * o + o) * (M if k < cfg.split_layers else 1)
                 for k, (i, o) in enumerate(layers))
    assert r["flops"] == products + 2 * params
    assert r["launches"] == {"k1": 1, "k2": 0, "k3": 0, "k4": 0}
    assert r["k1_leaves"] == 2 * len(layers)
    assert r["peak_bytes"] >= r["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma3-12b", "whisper-tiny",
                                  "deepseek-moe-16b"])
def test_train_launches_equal_the_formula(arch):
    cfg = get_config(arch, smoke=True)
    M = 2
    r = dryrun.run_program(build_model(cfg), "train", M, 1, 32, optimizer=sgd(0.05),
                           lr=0.05, device="cpu")
    want = dryrun.launches_per_round(cfg, M, cfg.microbatches)
    k2 = r["kernels"]["k2"]["by_key"]
    assert r["launches"]["k2"] == want["k2"] > 0
    assert k2.get("bidir", 0) == want["k2_bidir"]
    assert k2.get("cross", 0) == want["k2_cross"]
    assert r["launches"]["k3"] == want["k3"]
    assert r["launches"]["k1"] == 1 and r["launches"]["k4"] == 0
    assert r["flops"] > 0 and r["bytes_accessed"] > 0


# ---------------------------------------------------------------------------
# the collective summary, the build cache, the CLI
# ---------------------------------------------------------------------------


def test_collective_summary_is_the_references():
    counts = {"all-reduce": (3, 526_900), "all-gather": (2, 80)}
    ref, port = RefStats(), CollectiveStats()
    for kind, (n, nbytes) in counts.items():
        for s in (ref, port):
            s.count_by_kind[kind] += n
            s.bytes_by_kind[kind] += nbytes
    assert port.summary() == ref.summary()
    assert port.total_bytes == ref.total_bytes == 526_980


def test_enable_compilation_cache_round_trips(tmp_path, monkeypatch):
    before = build.BUILD_DIR
    try:
        monkeypatch.delenv(ENV_VAR, raising=False)
        assert enable_compilation_cache() is None and build.BUILD_DIR == before
        got = enable_compilation_cache(str(tmp_path / "kernels"))
        assert got == str((tmp_path / "kernels").resolve())
        assert build.library_path("x", []).parent == Path(got)
        monkeypatch.setenv(ENV_VAR, str(tmp_path / "env"))
        assert enable_compilation_cache() == str((tmp_path / "env").resolve())
        assert enable_compilation_cache() == str((tmp_path / "env").resolve())
    finally:
        build.BUILD_DIR = before


def test_cli_one_decode_program_exits_zero(capsys):
    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "=== dry-run summary: 1 OK, 0 SKIPPED, 0 FAILED of 1" in out
