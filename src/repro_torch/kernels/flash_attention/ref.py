"""Plain-torch attention oracle (grouped-query, causal / sliding-window /
non-causal / cross), the port of `repro.kernels.flash_attention.ref`.
Prefill and chunked extend use it, as the reference does. It is also the
plain version of the flash-attention kernel (K2, `csrc/flash_attention.cu`),
the path of CPU tensors in the training forward, and the function that K2's
backward differentiates (through `mha_grouped`, uncounted). `mha_chunked`,
the online-softmax form over KV chunks, is K2's plain version under
cfg.attn_impl = "chunked".
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.counts import register

NEG_INF = -1e30


def attn_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset=0,
    kv_valid=None,
    device=None,
) -> torch.Tensor:
    """Boolean [q_len, kv_len] (or [B, q_len, kv_len]) mask; True = attend.

    q_offset: absolute position of q[0] relative to kv[0]: an int, or a [B]
        tensor of per-row offsets (slot-based decode / chunked extend).
    window: sliding-window size (0 = unlimited). position i attends j iff
        j <= i (causal) and i - j < window.
    kv_valid: optional [B] number of valid kv slots.
    """
    qpos = torch.arange(q_len, device=device)[:, None]  # [q,1]
    kpos = torch.arange(kv_len, device=device)[None, :]  # [1,k]
    if torch.is_tensor(q_offset) and q_offset.ndim:
        qpos = qpos[None] + q_offset.to(device).reshape(-1, 1, 1)  # [B,q,1]
        kpos = kpos[None]  # [1,1,k]
        mask = torch.ones((q_offset.shape[0], q_len, kv_len), dtype=torch.bool,
                          device=device)
    else:
        qpos = qpos + int(q_offset)
        mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (qpos - kpos < window)
    if kv_valid is not None:
        kv_valid = torch.as_tensor(kv_valid, device=device)
        if mask.ndim == 2:
            mask = mask[None]
        kpos_b = kpos if kpos.ndim == 3 else kpos[None]
        mask = mask & (kpos_b < kv_valid.reshape(-1, 1, 1))
    return mask


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset=0, kv_valid=None) -> torch.Tensor:
    """`mha_grouped`, with its calls on CUDA tensors counted."""
    if q.is_cuda:
        mha_reference.cuda_calls += 1
    return mha_grouped(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, kv_valid=kv_valid)


def mha_grouped(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset=0,
    kv_valid=None,
) -> torch.Tensor:
    """Grouped-query attention, scores and softmax in f32, probabilities
    cast to v's dtype for the value product. Returns [B, Sq, Hq, D]. A row
    with no visible slot averages over the masked ones, as the reference
    does (serving never produces one)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    # 1/sqrt(D) rounded to f32, as the reference; a Python float, so no
    # host->device copy
    scale = (1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))).item()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = attn_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                     kv_valid=kv_valid, device=q.device)
    if mask.ndim == 2:
        mask = mask[None, None, None]  # [1,1,1,q,k]
    else:  # [B,q,k]
        mask = mask[:, None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)


def mha_chunked(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of `chunk` keys (the
    reference's `mha_chunked`, its scan a loop): the [Sq, Sk] score matrix
    is never whole, only [Sq, chunk] of it at a time, and each chunk's
    step is recomputed in the backward (`torch.utils.checkpoint`), so
    training memory stays chunked too. The same function as
    `mha_reference`, rounded apart. It is the plain version of K2 under
    cfg.attn_impl = "chunked", which CPU tensors run; a row with no
    visible key gives 0."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = (Sk + pad) // chunk
    qg = q.reshape(B, Sq, Hkv, G, D)
    scale = (1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))).item()
    qpos = torch.arange(Sq, device=q.device)

    def body(m_prev, l_prev, acc, k_c, v_c, ci):
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_c.float()) * scale
        mask = (kpos[None, :] < Sk).expand(Sq, chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l_new = l_prev * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v_c.dtype), v_c).float()
        return m_new, l_new, acc

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        k_c = k[:, ci * chunk:(ci + 1) * chunk]
        v_c = v[:, ci * chunk:(ci + 1) * chunk]
        if torch.is_grad_enabled():
            m, denom, acc = checkpoint(body, m, denom, acc, k_c, v_c, ci,
                                       use_reentrant=False)
        else:
            m, denom, acc = body(m, denom, acc, k_c, v_c, ci)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (acc / denom[..., None]).to(q.dtype)  # [B, Hkv, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)


# calls on CUDA tensors (serving prefill and extend make them; the training
# forward on the card goes through K2 and must make none)
register(mha_reference, "cuda_calls")
