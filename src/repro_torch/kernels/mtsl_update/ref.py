"""Plain PyTorch version of the fused MTSL update (paper Alg. 1 lines
11/15), the oracle of `csrc/mtsl_update.cu`:

    p_new = p - eta * g

computed in f32 and cast back to p's dtype, with the leaf viewed as
`[R, numel / R]` and row r using eta[r] (R = 1: one step size for the
whole leaf, as the reference's `mtsl_update_reference` takes it). The
product is rounded before the subtraction, as the kernel rounds it, so
the two agree bit for bit.

The CPU tests and the wrapper's CPU path use it, and `chip_smoke.py`
holds the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def eta_rows(eta, device) -> torch.Tensor:
    """A step size as an f32 [R] tensor on `device` (a float is filled on
    the device: no host->device copy)."""
    if not torch.is_tensor(eta):
        return torch.full((1,), float(eta), dtype=torch.float32, device=device)
    return eta.to(device=device, dtype=torch.float32).reshape(-1)


def mtsl_update_reference(p: torch.Tensor, g: torch.Tensor, eta) -> torch.Tensor:
    """p - eta * g as a new tensor of p's shape and dtype; eta a float or
    an [R] tensor with R dividing p.numel()."""
    if p.is_cuda:
        mtsl_update_reference.cuda_calls += 1
    eta = eta_rows(eta, p.device)
    R = eta.numel()
    pf = p.reshape(R, -1).float()
    step = eta[:, None] * g.reshape(R, -1).float()
    return (pf - step).to(p.dtype).reshape(p.shape)


# calls made on CUDA tensors: the training path must leave this at 0 (the
# wrapper sends CUDA tensors to the kernel); only kernel-vs-plain checks
# call the plain version on the card
mtsl_update_reference.cuda_calls = 0
