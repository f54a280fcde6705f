"""The port's SSD scan (K3's plain version and its autograd wrapper)
against the JAX reference: `repro.kernels.ssd_scan.ops.ssd_scan` (the
Pallas kernel in interpret mode) and `ssd_reference`, on the same numpy
inputs. Cases: the reference's SSD_CASES shapes in f32 (several H, P, N and
chunk), a nonzero initial state (against `ssd_reference(initial_state=)`),
and the final state. Tolerances as in tests/test_kernels.py: y within
2e-5, the state within 1e-4; gradients through the wrapper (which
recomputes through the plain version) within 1e-4 of JAX's (of
`ssd_reference`'s with an initial state, to which the reference's wrapper
takes no gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_reference as jax_ssd_reference
from repro_torch.kernels.ssd_scan import ssd_reference, ssd_scan

CASES = [
    # (B, L, H, P, N, chunk)
    (2, 64, 3, 8, 16, 16),
    (1, 128, 2, 16, 8, 32),
    (2, 32, 1, 4, 4, 32),
    (1, 64, 4, 32, 64, 16),
]


def _inputs(case, seed=2, state=False):
    B, L, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, L, H, P)).astype(np.float32),
           rng.uniform(0.01, 0.2, size=(B, L, H)).astype(np.float32),
           -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
           rng.normal(size=(B, L, N)).astype(np.float32),
           rng.normal(size=(B, L, N)).astype(np.float32)]
    if state:
        out.append(rng.normal(size=(B, H, P, N)).astype(np.float32))
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_kernel_and_reference(case):
    chunk = case[-1]
    arrs = _inputs(case)
    y, st = ssd_reference(*map(torch.tensor, arrs), chunk=chunk)
    yk, sk = jax_ssd_scan(*map(jnp.asarray, arrs), chunk)  # interpret mode
    yr, sr = jax_ssd_reference(*map(jnp.asarray, arrs), chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert tuple(st.shape) == (case[0], case[2], case[3], case[4])
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), atol=1e-4)


@pytest.mark.parametrize("case", CASES[:2])
def test_initial_state(case):
    chunk = case[-1]
    arrs = _inputs(case, seed=4, state=True)
    t = list(map(torch.tensor, arrs))
    y, st = ssd_scan(*t[:5], chunk=chunk, initial_state=t[5])
    yr, sr = jax_ssd_reference(*map(jnp.asarray, arrs[:5]), chunk=chunk,
                               initial_state=jnp.asarray(arrs[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_gradients_match_jax(with_state):
    case = (2, 32, 2, 4, 8, 16)
    chunk = case[-1]
    arrs = _inputs(case, seed=6, state=with_state)
    rng = np.random.default_rng(7)
    gy = rng.normal(size=arrs[0].shape).astype(np.float32)
    gs = rng.normal(size=(case[0], case[2], case[3], case[4])).astype(np.float32)

    def f_jax(*a):
        if with_state:  # the reference's wrapper takes no gradient to it
            y, s = jax_ssd_reference(*a[:5], chunk=chunk, initial_state=a[5])
        else:
            y, s = jax_ssd_scan(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(f_jax, argnums=tuple(range(len(arrs))))(*map(jnp.asarray, arrs))
    t = [torch.tensor(a, requires_grad=True) for a in arrs]
    y, s = ssd_scan(*t[:5], chunk=chunk, initial_state=t[5] if with_state else None)
    ((y * torch.tensor(gy)).sum() + (s * torch.tensor(gs)).sum()).backward()
    for a, w in zip(t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_wrapper_refuses_a_ragged_length():
    arrs = list(map(torch.tensor, _inputs((1, 24, 1, 4, 4, 16))))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(*arrs, chunk=16)
