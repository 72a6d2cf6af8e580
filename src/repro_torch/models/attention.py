"""Attention: the prefill path (full-sequence GQA: causal self-attention,
full encoder self-attention, and cross-attention of Sq queries over Sk
keys) and the decode path over a KV cache.

`chunked_attention` is the reference's online-softmax loop over KV
chunks (`repro/models/attention.py`) for tensors on the CPU.  For
tensors on the card it goes through `kernels.ops.attention_op`, the
hand-written flash-attention kernel, which computes the same function
(the reference's "TPU-tiled twin" of this loop, `flash_attention`):
causal with Sq == Sk, or full with any Sq and Sk.  A call the kernel
cannot compute (a query offset, or causal with Sq != Sk) raises.
Under grad the card's call carries its gradient through the kernel's
backward (`kernels.flash_attention.FlashAttention`), which takes
Sq == Sk only: a grad-requiring call at Sq != Sk raises on the card
before anything launches (ROADMAP queue C 13).  On the CPU torch
autograd differentiates the loop, as the reference differentiates its
own.  DTensor inputs (the partitioned train step) reach either route
on each rank's local batch rows and heads
(`distributed.sharding.on_local_heads`).

Decode is a single-query einsum over the cache with float32 scores,
plain PyTorch: the reference has no kernel there either.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import ops as kernels_ops

NEG_INF = -1e30


def _scale(d: int) -> torch.Tensor:
    """1/sqrt(d) computed in float32, as the reference computes it."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def gqa_repeat(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv*group, S, D); no copy when group == 1."""
    if group == 1:
        return x
    return torch.repeat_interleave(x, group, dim=1)


def chunked_attention(
    q: torch.Tensor,        # (B, Hq, Sq, D)
    k: torch.Tensor,        # (B, Hkv, Sk, D)
    v: torch.Tensor,        # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    chunk: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention, scanning KV in chunks of ``chunk`` (the
    CPU); the flash-attention kernel on the card, which takes causal
    attention with Sq == Sk and full attention with any Sq and Sk, from
    position 0."""
    if q.device.type == "cuda":
        if q_offset != 0 or (causal and q.shape[2] != k.shape[2]):
            raise ValueError(
                "the flash-attention kernel computes attention from position 0, "
                f"causal only with Sq == Sk (got Sq={q.shape[2]}, Sk={k.shape[2]}, "
                f"q_offset={q_offset}, causal={causal})")
        return kernels_ops.attention_op(q, k, v, causal=causal)
    if sharding.is_dtensor(q):
        return sharding.on_local_heads(sharding.with_contiguous_grads(
            functools.partial(chunked_attention, causal=causal, chunk=chunk,
                              q_offset=q_offset)), q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    chunk = min(chunk, sk)
    valid_sk = sk
    if sk % chunk != 0:  # pad kv to a chunk multiple; padded keys masked
        pad = chunk - sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        sk = sk + pad
    nchunks = sk // chunk
    scale = _scale(d)

    qf = q.float() * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kb = gqa_repeat(k[:, :, ci * chunk:(ci + 1) * chunk], group).float()
        vb = gqa_repeat(v[:, :, ci * chunk:(ci + 1) * chunk], group).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        if causal:
            mask = (qpos[:, None] >= kpos[None, :]) & (kpos < valid_sk)[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
        elif valid_sk != sk:
            s = torch.where((kpos < valid_sk)[None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, Hq, 1, D) single new token
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    cache_len: Union[int, torch.Tensor],  # () or (B,) valid length
) -> torch.Tensor:
    b, hq, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qf = q[:, :, 0].float() * _scale(d)                              # (B, Hq, D)
    qg = qf.reshape(b, hkv, group, d).to(k_cache.dtype)
    # float32 scores from cache-dtype operands, as the reference's
    # preferred_element_type=f32: each product of two bf16 values is
    # exact in float32.  This upcasts one layer's cache slice, which is
    # small at the serving sizes of this port (B x Hkv x max_len x D).
    scores = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_cache.float())
    pos = torch.arange(s, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        valid = pos[None, :] < cache_len.reshape(-1, 1).expand(b, 1)  # (B, S)
    else:
        valid = (pos < int(cache_len))[None, :].expand(b, s)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def update_kv_cache(
    k_cache: torch.Tensor, v_cache: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor, pos: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one new (B, Hkv, 1, D) entry at position ``pos``, in place
    (the reference returns updated copies).  A position past the end is
    clamped to the last slot, as the reference's dynamic_update_slice
    clamps its start index."""
    p = min(max(int(pos), 0), k_cache.shape[2] - 1)
    k_cache[:, :, p] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, p] = v_new[:, :, 0].to(v_cache.dtype)
    return k_cache, v_cache
