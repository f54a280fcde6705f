"""The port's CUDA mtsl_update kernel (K1) against its plain PyTorch
version, on the card. Marked `cuda`: it skips without one (a CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_mtsl_update_cuda.py

The kernel rounds the product before the subtraction, as the plain version
does, so the two must agree bit for bit in f32 and in bf16. Cases: every
leaf shape of full paper-resnet16 with M = 10 and per-client step sizes
(one of them 0, a frozen client), the reference's test shapes with a
scalar step, odd sizes that miss the 16-byte vector path, a view whose
pointer is not 16-byte aligned, and a permuted (strided) gradient. The
train paths' leaves (full paper-resnet16 and paper-mlp) are read from
each model's initial tree, as the chip smoke reads them. The multi-tensor
call (`mtsl_update_multi_`) must give the same bits in one launch: each
whole tree, unaligned and odd leaves, f32 and bf16 leaves together.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mtsl import init_state
from repro_torch.core.split import is_client_path
from repro_torch.kernels.mtsl_update.ops import mtsl_update_, mtsl_update_multi_
from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import tree_leaves_with_path


def _train_leaves(arch):
    """(shape, rows) of every leaf of `arch`'s full-size initial tree:
    towers [M, ...] take one step size per client, the server R = 1."""
    cfg = get_config(arch)
    M = cfg.num_clients
    tree = init_state(build_model(cfg), torch.Generator().manual_seed(0), M)
    return [pytest.param(tuple(x.shape), M if is_client_path(k) else 1, id=k)
            for k, x in tree_leaves_with_path(tree)]


SCALAR_SHAPES = [(3, 5), (128,), (7, 129), (2, 3, 4), (2003,), (1,)]


def _inputs(shape, dtype, rows, seed=0):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    p = torch.tensor(rng.normal(size=shape), dtype=dt, device="cuda")
    g = torch.tensor(rng.normal(size=shape), dtype=dt, device="cuda")
    eta = torch.tensor(rng.uniform(0, 10, size=rows), dtype=torch.float32,
                       device="cuda")
    eta[0] = 0.0
    return p, g, eta


def _check(p, g, eta):
    ref = mtsl_update_reference(p, g, eta)
    n, plain = mtsl_update_.launches, mtsl_update_reference.cuda_calls
    multi = mtsl_update_multi_.launches, mtsl_update_multi_.leaves
    ptr = p.data_ptr()
    out = mtsl_update_(p, g, eta)
    torch.cuda.synchronize()
    assert out is p and p.data_ptr() == ptr
    assert mtsl_update_.launches == n + 1
    assert (mtsl_update_multi_.launches, mtsl_update_multi_.leaves) == multi
    assert mtsl_update_reference.cuda_calls == plain
    assert torch.equal(out, ref)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", _train_leaves("paper-resnet16"))
def test_kernel_equals_plain_on_resnet16_leaves(shape, rows, dtype):
    _need_card()
    _check(*_inputs(shape, dtype, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", _train_leaves("paper-mlp"))
def test_kernel_equals_plain_on_mlp_leaves(shape, rows, dtype):
    _need_card()
    _check(*_inputs(shape, dtype, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCALAR_SHAPES)
def test_kernel_equals_plain_with_scalar_eta(shape, dtype):
    _need_card()
    p, g, _ = _inputs(shape, dtype, 1)
    _check(p, g, 0.1)
    _check(p, g, torch.tensor([9.75], device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_unaligned_views_and_odd_rows(dtype):
    """A view one element into its storage misses the 16-byte vector path;
    rows of odd length (3 x 7) cannot take vectors either."""
    _need_card()
    p, g, _ = _inputs((4097,), dtype, 1, seed=1)
    _check(p[1:], g[1:], torch.tensor([0.5], device="cuda"))
    p, g, eta = _inputs((3, 7), dtype, 3, seed=2)
    _check(p, g, eta)


@pytest.mark.cuda
def test_kernel_takes_a_permuted_gradient():
    """A conv weight's gradient comes back permuted (HWIO <-> OIHW view):
    the wrapper copies a strided g to p's layout; p stays in place."""
    _need_card()
    p, g, eta = _inputs((10, 3, 3, 16, 32), "float32", 10, seed=3)
    g_perm = g.permute(0, 4, 3, 1, 2).contiguous().permute(0, 3, 4, 2, 1)
    assert not g_perm.is_contiguous() and torch.equal(g_perm, g)
    _check(p, g_perm, eta)


@pytest.mark.cuda
def test_kernel_rejects_bad_input():
    _need_card()
    p, g, eta = _inputs((10, 4), "float32", 10)
    with pytest.raises(ValueError, match="dtype"):
        mtsl_update_(p, g.double(), eta)
    with pytest.raises(ValueError, match="rows"):
        mtsl_update_(p, g, eta[:3])
    with pytest.raises(ValueError, match="contiguous"):
        mtsl_update_(p.t(), g.t(), eta[:1])


def _tree(arch, dtype, seed=4):
    """Every leaf of `arch`'s full tree with its gradient and step sizes."""
    cases = [_inputs(pr.values[0], dtype, pr.values[1], seed=seed + i)
             for i, pr in enumerate(_train_leaves(arch))]
    return [list(col) for col in zip(*cases)]


def _check_multi(ps, gs, etas):
    refs = [mtsl_update_reference(p, g, e) for p, g, e in zip(ps, gs, etas)]
    n, leaves = mtsl_update_multi_.launches, mtsl_update_multi_.leaves
    single, plain = mtsl_update_.launches, mtsl_update_reference.cuda_calls
    ptrs = [p.data_ptr() for p in ps]
    mtsl_update_multi_(ps, gs, etas)
    torch.cuda.synchronize()
    assert mtsl_update_multi_.launches == n + 1
    # leaves updated: an empty leaf has no row in the table and is not counted
    assert mtsl_update_multi_.leaves == leaves + sum(p.numel() > 0 for p in ps)
    assert mtsl_update_.launches == single
    assert mtsl_update_reference.cuda_calls == plain
    assert [p.data_ptr() for p in ps] == ptrs
    for p, ref in zip(ps, refs):
        assert torch.equal(p, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["paper-resnet16", "paper-mlp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_kernel_updates_a_whole_tree_in_one_launch(arch, dtype):
    _need_card()
    _check_multi(*_tree(arch, dtype))


@pytest.mark.cuda
def test_multi_kernel_unaligned_odd_and_mixed_leaves():
    """Views one element into their storage, sizes that leave a scalar
    tail or miss the vector path, rows of odd length, a leaf past one
    piece, an empty leaf, a permuted gradient, and f32 and bf16 leaves in
    one launch."""
    _need_card()
    ps, gs, etas = [], [], []
    for i, (shape, dtype, rows) in enumerate([
            ((4097,), "float32", 1), ((2003,), "float32", 1), ((1,), "bfloat16", 1),
            ((3, 7), "float32", 3), ((5, 9), "bfloat16", 5), ((20001,), "bfloat16", 1),
            ((10, 3, 3, 16, 32), "float32", 10), ((4, 8, 8), "bfloat16", 4),
            ((2, 0), "float32", 1)]):
        p, g, eta = _inputs(shape, dtype, rows, seed=10 + i)
        if i == 0:
            p, g = p[1:], g[1:]
        ps.append(p), gs.append(g), etas.append(eta)
    g = gs[6]
    gs[6] = g.permute(0, 4, 3, 1, 2).contiguous().permute(0, 3, 4, 2, 1)
    assert not gs[6].is_contiguous() and torch.equal(gs[6], g)
    _check_multi(ps, gs, etas)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_kernel_holds_zero_step_rows(dtype):
    """The baselines' straggler hold: one launch over a table whose step
    sizes are partly 0 (the per-client rows of a full model, held rows
    where a client is past its budget; a per-cluster leaf with an idle
    cluster; a shared leaf on a step with no active client) leaves every
    held row bit-unchanged and steps the others as the plain version."""
    _need_card()
    M, C = 10, 2
    live = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 1, 1], dtype=torch.float32,
                        device="cuda")
    # every leaf of full paper-resnet16 as a per-client copy [M, ...]
    shapes = [(shape if rows == M else (M,) + shape, M) for shape, rows in
              (pr.values for pr in _train_leaves("paper-resnet16"))]
    shapes += [((C, 3, 3, 32, 64), C), ((64, 10), 1), ((4097,), 1)]
    ps, gs, etas = [], [], []
    for i, (shape, rows) in enumerate(shapes):
        p, g, _ = _inputs(shape, dtype, rows, seed=40 + i)
        eta = {M: 0.1 * live, C: torch.tensor([0.0, 0.1], device="cuda"),
               1: torch.zeros(1, device="cuda")}[rows]
        ps.append(p), gs.append(g), etas.append(eta)
    before = [p.clone() for p in ps]
    _check_multi(ps, gs, etas)
    for p, b, eta in zip(ps, before, etas):
        held = eta == 0
        assert held.any()
        assert torch.equal(p.reshape(eta.numel(), -1)[held],
                           b.reshape(eta.numel(), -1)[held])
