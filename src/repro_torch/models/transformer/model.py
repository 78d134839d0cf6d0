"""Decoder-only LM (``repro.models.transformer.model``): every assigned
configuration, dense (gemma3-1b, starcoder2-7b, yi-9b) and
mixture-of-experts (granite-moe-1b-a400m, mixtral-8x7b).

  * parameters are a tree ``{"embed", "layers": {name: (L, ...)}, "final_ln"}``
    (plus ``"lm_head"`` untied), the JAX package's keys and shapes (an MoE
    layer's ``router`` (L, d, E) and experts ``w_gate``/``w_in`` (L, E, d,
    f), ``w_out`` (L, E, f, d)), so its parameters pass through ``interop``
    unchanged
  * the layer loop runs each layer with its entry of ``layer_pattern``
    (window or None), in place of the JAX package's scan over periods
  * entry points: ``lm_loss`` (train), ``forward`` (logits), ``prefill``
    (KV cache + last logits), ``decode_step`` (one token against the
    cache); ``trunk`` gives the hidden states.  Prefill and forward attend
    through the flash-attention kernel (``kernels.ops.flash_attention``:
    the kernel on the card, its plain version on the CPU); decode through
    the plain ``attention.decode_attention``, as in the JAX package.
    ``lm_loss`` attends through the plain chunked ``attention.gqa_attention``
    (``q_chunk`` queries at a time), as the JAX loss does: the kernel has no
    backward (ROADMAP: kernel 7's backward)
  * an MoE layer's FFN is ``moe.moe_ffn`` on the call's tokens, in groups of
    ``min(moe_group_size, B S)`` (a decode step routes its B tokens as one
    group); B S must be a multiple of the group, else it raises
  * params are stored f32; every call casts them to ``compute_dtype``
    (bf16); KV caches are bf16.  ``decode_step`` writes the new position
    into the cache it is given, in place (the JAX function returns a new
    cache): a copy of a full cache each step would double its memory

Not ported: the mesh hooks (``act_constraint``, ``act_gather``,
``kv_constraint``), sharding constraints that one device has no use for;
on a mesh the per-position program is ``parallel``'s.  ``micro_batches``
and ``fsdp`` are the reference's fields, read by ``launch.steps`` and
``sharding.rules``.  The entry points run on the card
unless the caller passes ``device="cpu"``; the parameters must already be
there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.device import init_device, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.transformer import attention as attn_lib
from repro_torch.models.transformer import moe as moe_lib


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 10000.0
    mlp_type: str = "swiglu"                 # swiglu | geglu | gelu
    # per-layer attention pattern, repeated over depth. Entries: window size
    # (sliding-window attention) or None (full causal).
    layer_pattern: tuple[Any, ...] = (None,)
    tie_embeddings: bool = False
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_impl: str = "einsum"
    moe_fused_combine: bool = False
    aux_loss_weight: float = 0.01
    # numerics / execution
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # lm_loss: checkpoint each layer (the backward recomputes it), attend
    # q_chunk queries at a time, and take the cross-entropy over chunks of
    # loss_chunk positions, each checkpointed, so the (B, S, vocab) f32
    # logits never exist, forward or backward
    remat: bool = True
    q_chunk: int = 512
    loss_chunk: int = 512
    # gradient-accumulation microbatches of a train cell (1 = the full
    # batch at once; ``launch.steps`` runs ``optim.gradient_accumulation``)
    micro_batches: int = 1
    # FSDP: every large weight also split over the ``data`` axis
    # (``sharding.rules.lm_param_specs``): on a mesh with data replicas each
    # block is all-gathered before its layer (``parallel``); with one data
    # replica it changes no computation
    fsdp: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 128 (the JAX package shards the vocab axis
        over any mesh axis <= 128 wide).  Padded logit columns are masked
        to -1e30 in ``_logits``."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def moe_cfg(self) -> moe_lib.MoEConfig:
        return moe_lib.MoEConfig(
            n_experts=self.n_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            group_size=self.moe_group_size, impl=self.moe_impl,
            fused_combine=self.moe_fused_combine,
        )

    def window(self, layer: int):
        """Layer ``layer``'s attention window (None: full causal)."""
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def n_params(self) -> int:
        """Total parameter count."""
        return sum(math.prod(s) for s in _shapes(self).values())

    def n_active_params(self) -> int:
        """Active params per token (MoE counts top_k of n_experts)."""
        total = self.n_params()
        if not self.is_moe:
            return total
        expert_block = 3 * self.d_model * self.d_ff * self.n_layers
        return total - expert_block * self.n_experts + expert_block * self.top_k


def _shapes(cfg: TransformerConfig) -> dict:
    """``{path: shape}`` of every parameter, paths as in the tree
    (``"layers/wq"``), in the JAX package's init order."""
    L, d, H, KV, hd, f = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff)
    shapes = {"layers/ln_attn": (L, d), "layers/wq": (L, d, H * hd),
              "layers/wk": (L, d, KV * hd), "layers/wv": (L, d, KV * hd),
              "layers/wo": (L, H * hd, d), "layers/ln_mlp": (L, d)}
    if cfg.is_moe:
        E = cfg.n_experts
        shapes.update({"layers/router": (L, d, E), "layers/w_gate": (L, E, d, f),
                       "layers/w_in": (L, E, d, f), "layers/w_out": (L, E, f, d)})
    else:
        if cfg.mlp_type in ("swiglu", "geglu"):
            shapes["layers/w_gate"] = (L, d, f)
        shapes["layers/w_in"] = (L, d, f)
        shapes["layers/w_out"] = (L, f, d)
    shapes["embed"] = (cfg.vocab_padded, d)
    shapes["final_ln"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_padded)
    return shapes


def init_scale(name: str, shape: tuple) -> float:
    """The standard deviation ``init`` gives a leaf: 0.02 for the
    embedding, else the JAX package's ``_init_linear`` rule, 1 / sqrt of
    ``shape[0]`` for a 2-D map and of ``shape[1]`` otherwise (``d`` for a
    stacked (L, d, n) map and the router, ``E`` for an expert stack (L, E,
    ., .))."""
    if name == "embed":
        return 0.02
    return float(1.0 / np.sqrt(shape[0] if len(shape) == 2 else shape[1]))


def init(generator: torch.Generator, cfg: TransformerConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's): norms
    at 1, every other leaf normal times ``init_scale``."""
    dev, dt = init_device(generator, device), cfg.param_dtype
    params: dict = {"layers": {}}
    for path, shape in _shapes(cfg).items():
        name = path.split("/")[-1]
        if name in ("ln_attn", "ln_mlp", "final_ln"):
            t = torch.ones(shape, dtype=dt, device=dev)
        else:
            t = (torch.randn(shape, generator=generator, device=dev)
                 * init_scale(name, shape)).to(dt)
        if path.startswith("layers/"):
            params["layers"][name] = t
        else:
            params[name] = t
    return params


def cast_params(params: dict, dtype) -> dict:
    return {name: cast_params(p, dtype) if isinstance(p, dict) else p.to(dtype)
            for name, p in params.items()}


def _rms(x, scale, eps=1e-6):
    var = (x.float() ** 2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def _mlp(lp, cfg, x):
    if cfg.is_moe:
        return moe_lib.moe_ffn(x, lp["router"], lp["w_gate"], lp["w_in"], lp["w_out"],
                               cfg.moe_cfg)
    if cfg.mlp_type == "swiglu":
        a = F.silu(x @ lp["w_gate"]) * (x @ lp["w_in"])
    elif cfg.mlp_type == "geglu":
        a = F.gelu(x @ lp["w_gate"], approximate="tanh") * (x @ lp["w_in"])
    else:
        a = F.gelu(x @ lp["w_in"], approximate="tanh")
    return a @ lp["w_out"]


def attention_inputs(lp, cfg, x, positions):
    """The attention inputs of one layer: rope'd q (B, S, H, hd), k and v
    (B, S, KV, hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = _rms(x, lp["ln_attn"])
    q = (h @ lp["wq"]).reshape(B, S, H, hd)
    k = (h @ lp["wk"]).reshape(B, S, KV, hd)
    v = (h @ lp["wv"]).reshape(B, S, KV, hd)
    return (attn_lib.rope(q, positions, cfg.rope_theta),
            attn_lib.rope(k, positions, cfg.rope_theta), v)


def finish_layer(lp, cfg, x, o):
    """The rest of a layer after attention: output projection, residual,
    MLP."""
    B, S, _ = x.shape
    x = x + (o.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["wo"])
    return x + _mlp(lp, cfg, _rms(x, lp["ln_mlp"]))


def _layer(lp: dict, cfg: TransformerConfig, window, x, positions, kv_slice=None,
           cache_index=None):
    """One transformer layer.  lp: this layer's params (no L dim).

    Returns (x, (k, v)): without ``kv_slice`` the layer attends over its own
    positions 0..S-1 through the flash-attention kernel and returns its new
    k/v; with ``kv_slice = (k_cache, v_cache)`` (B, S_max, KV, hd) it writes
    its k/v at ``cache_index``, in place, and attends against the cache."""
    q, k, v = attention_inputs(lp, cfg, x, positions)
    if kv_slice is None:
        o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                window=window)
        new_kv = (k, v)
    else:
        k_cache, v_cache = kv_slice
        S = x.shape[1]
        k_cache[:, cache_index:cache_index + S] = k.to(k_cache.dtype)
        v_cache[:, cache_index:cache_index + S] = v.to(v_cache.dtype)
        o = attn_lib.decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                                      n_kv_heads=cfg.n_kv_heads, cache_index=cache_index,
                                      window=window)
        new_kv = (k_cache, v_cache)
    return finish_layer(lp, cfg, x, o), new_kv


def layer_params(cparams: dict, i: int) -> dict:
    return {name: p[i] for name, p in cparams["layers"].items()}


def _logits(params, cfg, x):
    x = _rms(x, params["final_ln"])
    out = x @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    if cfg.vocab_padded != cfg.vocab:   # mask pad columns out of softmaxes
        col = torch.arange(out.shape[-1], device=out.device)
        out = torch.where(col < cfg.vocab, out, torch.full_like(out, -1e30))
    return out


def _resolve(params: dict, device) -> torch.device:
    """The device an entry point runs on (cuda unless ``device`` names
    another); the parameters must be there."""
    dev = resolve_device(device)
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"parameters are on {have}, the call asks for {dev}")
    return have


def embed(cparams: dict, cfg: TransformerConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype (scaled by sqrt(d) when tied)."""
    x = cparams["embed"][tokens]
    if cfg.tie_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def trunk(params: dict, cfg: TransformerConfig, tokens, *, device=None):
    """tokens (B, S) -> (final hidden states (B, S, d) pre-final-norm, the
    parameters cast to the compute dtype)."""
    dev = _resolve(params, device)
    cparams = cast_params(params, cfg.compute_dtype)
    tokens = torch.as_tensor(tokens, device=dev)
    x = embed(cparams, cfg, tokens)
    pos = torch.arange(tokens.shape[1], device=dev)
    for i in range(cfg.n_layers):
        x, _ = _layer(layer_params(cparams, i), cfg, cfg.window(i), x, pos)
    return x, cparams


def forward(params: dict, cfg: TransformerConfig, tokens, *, device=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab_padded).  Eval forward."""
    x, cparams = trunk(params, cfg, tokens, device=device)
    return _logits(cparams, cfg, x)


def _train_layer(lp: dict, cfg: TransformerConfig, window, x, positions):
    """One layer of ``lm_loss``: attention through the plain chunked
    ``gqa_attention``, as the JAX package's ``_layer``."""
    q, k, v = attention_inputs(lp, cfg, x, positions)
    o = attn_lib.gqa_attention(q, k, v, n_kv_heads=cfg.n_kv_heads, q_positions=positions,
                               k_positions=positions, window=window, q_chunk=cfg.q_chunk)
    return finish_layer(lp, cfg, x, o)


def _chunk_ce(cparams: dict, cfg: TransformerConfig, x_c, labels_c):
    """Summed next-token cross-entropy of one chunk of positions, f32."""
    logits = _logits(cparams, cfg, x_c).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    return (logz - gold).sum()


def lm_loss(params: dict, cfg: TransformerConfig, batch: dict, *, device=None):
    """Next-token cross-entropy, the mean over ``batch = {tokens (B, S),
    labels (B, S)}``, f32 and differentiable in ``params``.

    Each layer runs under ``torch.utils.checkpoint`` when ``cfg.remat``;
    the unembedding and cross-entropy run over chunks of ``loss_chunk``
    positions, each under ``torch.utils.checkpoint``, so the full (B, S,
    vocab) f32 logits never exist (forward or backward).  Attention is the
    plain ``gqa_attention`` (never the kernel), as in the JAX loss."""
    dev = _resolve(params, device)
    cparams = cast_params(params, cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    x = embed(cparams, cfg, tokens)
    pos = torch.arange(tokens.shape[1], device=dev)
    for i in range(cfg.n_layers):
        args = (layer_params(cparams, i), cfg, cfg.window(i), x, pos)
        x = (checkpoint(_train_layer, *args, use_reentrant=False) if cfg.remat
             else _train_layer(*args))
    B, S, _ = x.shape
    c = min(cfg.loss_chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of loss_chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(S // c):
        sl = slice(j * c, (j + 1) * c)
        total = total + checkpoint(_chunk_ce, cparams, cfg, x[:, sl], labels[:, sl],
                                   use_reentrant=False)
    return total / (B * S)


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """(L, 2, B, S, KV, hd) KV cache of zeros."""
    return torch.zeros((cfg.n_layers, 2, batch, max_seq, cfg.n_kv_heads, cfg.hd),
                       dtype=dtype, device=resolve_device(device))


def prefill(params: dict, cfg: TransformerConfig, tokens, max_seq: int, *, device=None):
    """Process a prompt (any length S <= max_seq); returns (last-position
    logits (B, 1, vocab_padded), bf16 cache (L, 2, B, max_seq, KV, hd))
    holding positions 0..S-1."""
    dev = _resolve(params, device)
    cparams = cast_params(params, cfg.compute_dtype)
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"a prompt of {S} tokens does not fit a {max_seq}-slot cache")
    cache = init_cache(cfg, B, max_seq, device=dev)
    x = embed(cparams, cfg, tokens)
    pos = torch.arange(S, device=dev)
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(layer_params(cparams, i), cfg, cfg.window(i), x, pos)
        cache[i, 0, :, :S] = k.to(torch.bfloat16)
        cache[i, 1, :, :S] = v.to(torch.bfloat16)
    return _logits(cparams, cfg, x[:, -1:, :]), cache


def decode_step(params: dict, cfg: TransformerConfig, tokens, cache: torch.Tensor,
                cache_index: int, *, device=None):
    """One decode step.  tokens (B, 1); cache (L, 2, B, S_max, KV, hd),
    written at ``cache_index`` in place.  Returns (logits (B, 1,
    vocab_padded), the cache)."""
    dev = _resolve(params, device)
    cparams = cast_params(params, cfg.compute_dtype)
    tokens = torch.as_tensor(tokens, device=dev)
    cache_index = int(cache_index)
    x = embed(cparams, cfg, tokens)
    pos = torch.full((tokens.shape[0], 1), cache_index, device=dev)
    for i in range(cfg.n_layers):
        x, _ = _layer(layer_params(cparams, i), cfg, cfg.window(i), x, pos,
                      (cache[i, 0], cache[i, 1]), cache_index)
    return _logits(cparams, cfg, x), cache
