"""K1 (the fused MTSL update) in the PyTorch port against the JAX reference.

The port's plain version, which the wrapper runs on CPU tensors, is held
against the reference's `mtsl_update_reference` and its Pallas kernel in
interpret mode (`repro.kernels.mtsl_update.ops.mtsl_update`), on the
reference's own cases (tests/test_kernels.py): the shapes and dtypes at
1e-6 (f32) and 1e-2 (bf16), and the hypothesis sweep over n in [1, 2000]
and eta in [0, 10] at 1e-6 + 1e-6 |ref| (XLA may contract the update into
an FMA; the port rounds the product first, as its CUDA kernel does).
Per-row step sizes are checked against a loop of the reference over rows,
and the wrapper must update p in its own storage. The multi-tensor call
(`mtsl_update_multi_`, one launch per round on the card) must equal the
per-leaf loop bit for bit on whole trees, and its leaf table (the rows the
kernel walks) must carry each leaf's size, row length, first piece, dtype
code and vector flag. The CUDA kernels themselves are compared with the
plain version on the card in tests/test_torch_mtsl_update_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.mtsl_update.ops import mtsl_update as jax_mtsl_update
from repro.kernels.mtsl_update.ref import mtsl_update_reference as jax_reference
from repro_torch.kernels.mtsl_update import ops as k1
from repro_torch.kernels.mtsl_update.ops import leaf_table, mtsl_update_, mtsl_update_multi_
from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
from repro_torch.utils.tree import tree_leaves

TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


@pytest.mark.parametrize("shape", [(3, 5), (128,), (7, 129), (2, 3, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_update_matches_jax(shape, dtype):
    rng = np.random.default_rng(7)
    p_np, g_np = rng.normal(size=shape), rng.normal(size=shape)
    jp, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (p_np, g_np))
    p = torch.tensor(_f32(jp), dtype=getattr(torch, dtype))
    g = torch.tensor(_f32(jg), dtype=getattr(torch, dtype))
    out = mtsl_update_(p.clone(), g, 0.1)
    assert out.shape == shape and out.dtype == getattr(torch, dtype)
    for ref in (jax_reference(jp, jg, 0.1), jax_mtsl_update(jp, jg, 0.1)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype])
    assert torch.equal(out, mtsl_update_reference(p, g, 0.1))


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 2000),
    eta=st.floats(0.0, 10.0, allow_nan=False),
    seed=st.integers(0, 2**31 - 1),
)
def test_plain_update_sweep_matches_jax(n, eta, seed):
    rng = np.random.default_rng(seed)
    p_np = rng.normal(size=(n,)).astype(np.float32)
    g_np = rng.normal(size=(n,)).astype(np.float32)
    out = mtsl_update_(torch.from_numpy(p_np.copy()), torch.from_numpy(g_np), eta)
    ref = np.asarray(jax_reference(jnp.asarray(p_np), jnp.asarray(g_np), eta))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", [((10, 3, 3, 32, 32), 10), ((4, 64, 10), 4),
                                        ((6, 7), 3), ((5,), 5)])
def test_per_row_eta_is_a_loop_of_the_reference(shape, rows, dtype):
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    p = torch.tensor(rng.normal(size=shape), dtype=dt)
    g = torch.tensor(rng.normal(size=shape), dtype=dt)
    eta = torch.tensor(rng.uniform(0, 2, size=rows), dtype=torch.float32)
    eta[0] = 0.0  # a frozen (non-participating) client
    out = mtsl_update_(p.clone(), g, eta)
    pr, gr = p.reshape(rows, -1), g.reshape(rows, -1)
    for r in range(rows):
        ref = jax_reference(jnp.asarray(pr[r].float().numpy(), getattr(jnp, dtype)),
                            jnp.asarray(gr[r].float().numpy(), getattr(jnp, dtype)),
                            float(eta[r]))
        np.testing.assert_allclose(out.reshape(rows, -1)[r].float().numpy(), _f32(ref),
                                   rtol=1e-6, atol=TOL[dtype])
    assert torch.equal(out.reshape(rows, -1)[0], pr[0])  # eta 0: bit-frozen


def test_update_is_in_place_and_counts_no_cpu_launch():
    p = torch.randn(4, 6, requires_grad=True)
    g = torch.randn(4, 6)
    ptr, before = p.data_ptr(), p.detach().clone()
    launches, plain = mtsl_update_.launches, mtsl_update_reference.cuda_calls
    out = mtsl_update_(p, g, torch.full((4,), 0.5))
    assert out is p and p.data_ptr() == ptr
    assert torch.equal(p.detach(), (before - 0.5 * g))
    assert mtsl_update_.launches == launches
    assert mtsl_update_reference.cuda_calls == plain


def test_rows_must_divide_the_leaf():
    with pytest.raises(RuntimeError):
        mtsl_update_(torch.zeros(7), torch.zeros(7), torch.ones(2))


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
def test_fused_apply_matches_the_unfused_composition(opt_name):
    """per_component_lr's in-place apply (K1's path) against the
    reference's composition, written out with the port's own pieces:
    base update -> x ComponentLR -> x participation -> apply_updates.
    One rounding apart, so within 1e-6 after two steps."""
    from repro_torch.core.split import is_client_path
    from repro_torch.optim import adamw, apply_updates, momentum, sgd
    from repro_torch.optim.per_component import ComponentLR, per_component_lr

    rng = np.random.default_rng(0)
    M = 4

    def tree(seed):
        r = np.random.default_rng(seed)
        return {"towers": {"w": torch.tensor(r.normal(size=(M, 3, 5)), dtype=torch.float32)},
                "server": {"w": torch.tensor(r.normal(size=(5, 2)), dtype=torch.float32),
                           "b": torch.tensor(r.normal(size=(2,)), dtype=torch.float32)}}

    base = {"sgd": sgd(0.3), "momentum": momentum(0.3), "adamw": adamw(0.01)}[opt_name]
    opt = per_component_lr(base, is_client_path)
    clr = ComponentLR(torch.tensor(0.25), torch.tensor(rng.uniform(0.5, 2, M), dtype=torch.float32))
    part = torch.tensor([1.0, 0.0, 1.0, 1.0])
    fused, plain = tree(1), tree(1)
    s_fused = s_plain = opt.init(fused)
    for step in range(2):
        grads = tree(10 + step)
        s_fused = opt.apply_(fused, grads, s_fused, step, clr, part)
        upd, s_plain = opt.update(grads, s_plain, plain, step, clr)
        upd = {**upd, "towers": {k: u * part.reshape((M, 1, 1)) for k, u in upd["towers"].items()}}
        plain = apply_updates(plain, upd)
    for a, b in zip(tree_leaves(fused), tree_leaves(plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(fused["towers"]["w"][1], tree(1)["towers"]["w"][1])  # frozen


def _tree_case(arch, seed=0):
    """(leaves, grads, etas) of `arch`'s smoke tree: tower leaves [M, ...]
    take one step size per client (one of them 0, a frozen client), server
    leaves one; a bf16 leaf and an odd-sized one are appended."""
    from repro_torch.configs import get_config
    from repro_torch.core.mtsl import init_state
    from repro_torch.core.split import is_client_path
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves_with_path

    cfg = get_config(arch, smoke=True)
    M = cfg.num_clients
    rng = np.random.default_rng(seed)
    tree = init_state(build_model(cfg), torch.Generator().manual_seed(seed), M)
    eta_t = torch.tensor(rng.uniform(0, 10, size=M), dtype=torch.float32)
    eta_t[0] = 0.0
    eta_s = torch.tensor([rng.uniform(0, 10)], dtype=torch.float32)
    ps, etas = [], []
    for path, x in tree_leaves_with_path(tree):
        ps.append(x.detach().clone())
        etas.append(eta_t if is_client_path(path) else eta_s)
    ps += [torch.tensor(rng.normal(size=(M, 7, 3)), dtype=torch.bfloat16),
           torch.tensor(rng.normal(size=(2003,)), dtype=torch.float32)]
    etas += [eta_t, eta_s]
    gs = [torch.tensor(rng.normal(size=p.shape), dtype=p.dtype) for p in ps]
    return ps, gs, etas


@pytest.mark.parametrize("arch", ["paper-resnet16", "paper-mlp"])
def test_multi_update_equals_the_per_leaf_loop(arch):
    ps, gs, etas = _tree_case(arch)
    rows = {e.numel() for e in etas}
    assert len(rows) == 2 and 1 in rows  # R = M and R = 1 both present
    assert any(p.dtype == torch.bfloat16 for p in ps)
    loop = [mtsl_update_(p.clone(), g, e) for p, g, e in zip(ps, gs, etas)]
    multi = [p.clone() for p in ps]
    ptrs = [p.data_ptr() for p in multi]
    n, leaves = mtsl_update_multi_.launches, mtsl_update_multi_.leaves
    out = mtsl_update_multi_(multi, gs, etas)
    assert out is multi and [p.data_ptr() for p in multi] == ptrs  # in place
    assert all(torch.equal(a, b) for a, b in zip(multi, loop))
    # the plain CPU path is not counted
    assert (mtsl_update_multi_.launches, mtsl_update_multi_.leaves) == (n, leaves)


def test_leaf_table_rows():
    """Offsets, row lengths and dtype codes of the rows the kernel walks:
    an empty leaf has no row, pieces are whole multiples of PIECE, and the
    vector path is off where a row is not a whole number of 16-byte
    vectors or a base is not 16-byte aligned."""
    bf16 = torch.bfloat16
    ps = [torch.zeros(10, 3, 3, 32, 32), torch.zeros(0), torch.zeros(k1.PIECE + 1),
          torch.zeros(4, 6, dtype=bf16), torch.zeros(3, 7), torch.zeros(4097)[1:],
          torch.zeros(5, 6)]
    gs = [torch.zeros_like(p) for p in ps]
    etas = [torch.ones(10), torch.ones(1), torch.ones(1), torch.ones(4), torch.ones(3),
            torch.ones(1), torch.ones(5)]
    table, pieces = leaf_table(ps, gs, etas)
    col = {name: table[:, i].tolist() for i, name in enumerate(k1.TABLE_COLUMNS)}
    kept = [0, 2, 3, 4, 5, 6]  # the empty leaf has no row
    assert table.shape == (6, len(k1.TABLE_COLUMNS))
    assert col["p"] == [ps[i].data_ptr() for i in kept]
    assert col["g"] == [gs[i].data_ptr() for i in kept]
    assert col["eta"] == [etas[i].data_ptr() for i in kept]
    assert col["n"] == [92160, k1.PIECE + 1, 24, 21, 4096, 30]
    assert col["row_len"] == [9216, k1.PIECE + 1, 6, 7, 4096, 6]
    # 92160 elements take ceil(92160 / 8192) = 12 pieces, 8193 take 2
    assert col["piece0"] == [0, 12, 14, 15, 16, 17]
    assert pieces == 18
    assert col["dtype"] == [0, 0, 1, 0, 0, 0]
    # bf16 rows of 6 and f32 rows of 7 or 6 are not whole 16-byte vectors;
    # a view one element into its storage is not aligned
    assert col["vector"] == [1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("bad", ["rows", "dtype", "shape", "eta_dtype", "strided"])
def test_leaf_table_raises_on_what_the_kernel_cannot_take(bad):
    p, g, eta = torch.zeros(6, 4), torch.zeros(6, 4), torch.ones(6)
    if bad == "rows":
        eta = torch.ones(5)
    elif bad == "dtype":
        g = g.double()
    elif bad == "shape":
        g = torch.zeros(24)
    elif bad == "eta_dtype":
        eta = eta.double()
    elif bad == "strided":
        p, g = p.t(), g.t()
    with pytest.raises(ValueError):
        leaf_table([p], [g], [eta])
