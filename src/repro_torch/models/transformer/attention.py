"""Attention for the LM architectures (``repro.models.transformer.attention``):
GQA with RoPE, in plain PyTorch.

  * ``gqa_attention`` - causal, optionally sliding-window attention on
    explicit positions, whole or in query chunks (a window slices each
    chunk's keys to ``W + q_chunk``).
  * ``decode_attention`` - one new position per sequence against a full
    KV cache.

The prefill and forward passes of ``model`` go through the flash-attention
kernel (``kernels.ops.flash_attention``) instead; these are the plain
paths that the JAX package defines its numerics with, and decode's path.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S).  The
    angles in f32, cos and sin cast to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.as_tensor(1.0 / (theta ** (np.arange(0, half) * 2.0 / hd)),
                            dtype=torch.float32, device=x.device)
    ang = positions[..., None].float() * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)             # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q_pos, k_pos, window, softmax_scale):
    """q: (B, Sq, K, G, hd), k/v: (B, Skv, K, hd) -> (B, Sq, K, G, hd).  The
    scores come out of the product in q's dtype (bf16 rounds them there,
    as the JAX einsum does) and go through the softmax in f32."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * softmax_scale
    mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    if window is not None:
        mask = mask & (k_pos[:, None, None, None, :] > q_pos[:, None, None, :, None] - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def gqa_attention(q, k, v, *, n_kv_heads: int, q_positions, k_positions,
                  window: int | None = None, q_chunk: int | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA: ``q (B, Sq, H, hd)``,
    ``k, v (B, Skv, KV, hd)``, positions ``(B, S)`` or ``(S,)``.  Returns
    ``(B, Sq, H, hd)``."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    G = H // n_kv_heads
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Sq, n_kv_heads, G, hd)
    q_pos = torch.broadcast_to(q_positions, (B, Sq))
    k_pos = torch.broadcast_to(k_positions, (B, Skv))

    if q_chunk is None or Sq <= q_chunk:
        return _attend(qg, k, v, q_pos, k_pos, window, scale).reshape(B, Sq, H, hd)

    if Sq % q_chunk != 0:
        # pad queries to a chunk multiple; padded rows are sliced away.
        pad = q_chunk - Sq % q_chunk
        qg_p = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        qp_p = torch.nn.functional.pad(q_pos, (0, pad), value=0)
        out = gqa_attention(qg_p.reshape(B, Sq + pad, H, hd), k, v, n_kv_heads=n_kv_heads,
                            q_positions=qp_p, k_positions=k_pos, window=window,
                            q_chunk=q_chunk)
        return out[:, :Sq]
    span = None if window is None or window + q_chunk >= Skv else window + q_chunk
    outs = []
    for i in range(Sq // q_chunk):
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        k_i, v_i, kp_i = k, v, k_pos
        if span is not None:
            # keys needed by chunk i: positions (i*qc - W, i*qc + qc - 1]
            start = min(max(i * q_chunk + q_chunk - span, 0), Skv - span)
            k_i, v_i = k[:, start:start + span], v[:, start:start + span]
            kp_i = k_pos[:, start:start + span]
        outs.append(_attend(qg[:, sl], k_i, v_i, q_pos[:, sl], kp_i, window, scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def decode_attention(q, k_cache, v_cache, *, n_kv_heads: int, cache_index: int,
                     window: int | None = None) -> torch.Tensor:
    """One-step decode against a full cache (new k/v already written):
    ``q (B, 1, H, hd)``, caches ``(B, S, KV, hd)``."""
    B = q.shape[0]
    S = k_cache.shape[1]
    k_pos = torch.arange(S, device=q.device)
    q_pos = torch.full((B, 1), int(cache_index), device=q.device)
    return gqa_attention(q, k_cache, v_cache, n_kv_heads=n_kv_heads, q_positions=q_pos,
                         k_positions=k_pos, window=window, q_chunk=None)
