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
each model's initial tree, as the chip smoke reads them.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mtsl import init_state
from repro_torch.core.split import is_client_path
from repro_torch.kernels.mtsl_update.ops import mtsl_update_
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
    ptr = p.data_ptr()
    out = mtsl_update_(p, g, eta)
    torch.cuda.synchronize()
    assert out is p and p.data_ptr() == ptr
    assert mtsl_update_.launches == n + 1
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
