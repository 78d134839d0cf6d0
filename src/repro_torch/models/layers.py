"""Shared parameter-dict NN layers.  Port of ``repro.models.layers``.

Conventions, as in the JAX package:

  * every layer is an ``init_*(generator, ...) -> params_dict`` plus a plain
    ``apply_*`` function on tensors;
  * params are nested dicts of tensors with the JAX package's keys
    (``layer_i/{w,b}``, ``scale``/``bias``, ``wq``/``wk``/``wv``/``wo``),
    so ``repro_torch.interop`` carries weights across unchanged.

Tensors are made on the generator's device.  The attention here is over
SHORT sequences (recsys fields or a behaviour history, m <= ~64): plain
products and a softmax, as the JAX package computes it outside any Pallas
kernel.  Long-sequence LM attention is ``models.transformer.attention``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import init_device


def glorot(generator: torch.Generator, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    scale = np.sqrt(2.0 / (fan_in + fan_out))
    dev = init_device(generator, device)
    return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)


def he(generator: torch.Generator, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    scale = np.sqrt(2.0 / shape[-2])
    dev = init_device(generator, device)
    return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)


# -- MLP ----------------------------------------------------------------------

def init_mlp(generator: torch.Generator, dims: Sequence[int], dtype=torch.float32,
             device=None) -> dict:
    """dims = [in, h1, ..., out]."""
    dev = init_device(generator, device)
    return {
        f"layer_{i}": {
            "w": he(generator, (dims[i], dims[i + 1]), dtype, dev),
            "b": torch.zeros((dims[i + 1],), dtype=dtype, device=dev),
        }
        for i in range(len(dims) - 1)
    }


def apply_mlp(params: dict, x, *, activation=F.relu, final_activation=None):
    n = len(params)
    for i in range(n):
        p = params[f"layer_{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


# -- LayerNorm / RMSNorm ------------------------------------------------------

def init_layer_norm(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def apply_layer_norm(params: dict, x, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def init_rms_norm(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def apply_rms_norm(params: dict, x, eps: float = 1e-6):
    var = (x.float() ** 2).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"]


# -- dense multi-head attention over short sequences --------------------------

def init_mha(generator: torch.Generator, d_in: int, d_head: int, n_heads: int,
             d_out: int | None = None, dtype=torch.float32, device=None) -> dict:
    d_out = d_out or d_in
    return {
        "wq": glorot(generator, (d_in, n_heads * d_head), dtype, device),
        "wk": glorot(generator, (d_in, n_heads * d_head), dtype, device),
        "wv": glorot(generator, (d_in, n_heads * d_head), dtype, device),
        "wo": glorot(generator, (n_heads * d_head, d_out), dtype, device),
    }


def apply_mha(params: dict, x, *, n_heads: int, mask=None, scaled: bool = True):
    """x: (..., s, d_in) -> (..., s, d_out).  ``mask`` (..., s, s): a key
    where it is not > 0 gets the logit -1e30.  ``scaled=False`` drops the
    1/sqrt(d_head) (AutoInt)."""
    d_head = params["wq"].shape[-1] // n_heads

    def split(h):
        return h.reshape(*h.shape[:-1], n_heads, d_head)

    q = split(x @ params["wq"])
    k = split(x @ params["wk"])
    v = split(x @ params["wv"])
    logits = torch.einsum("...shd,...thd->...hst", q, k)
    if scaled:
        logits = logits / np.sqrt(d_head)
    if mask is not None:
        logits = torch.where(mask[..., None, :, :] > 0, logits, -1e30)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hst,...thd->...shd", attn, v)
    out = out.reshape(*out.shape[:-2], n_heads * d_head)
    return out @ params["wo"]


def logistic_loss(logits, label):
    """Mean binary cross-entropy on logits, in the numerically stable form
    the JAX recsys models write out: max(l, 0) - l y + log1p(exp(-|l|))."""
    y = label.to(logits.dtype)
    per = torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
    return per.mean()
