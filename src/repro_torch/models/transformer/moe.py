"""Mixture-of-Experts FFN (``repro.models.transformer.moe``): top-k routing
with per-group capacity, three dispatch implementations.

  * ``einsum``  - GShard-style dispatch and combine tensors (G, g, E, C),
                  contracted with batched matmuls.  The reference forms them
                  as sums of (g k, E, C) one-hot outer products; every
                  (token, expert, slot) holds at most one nonzero term, so
                  here they are scattered directly, to the same values.
  * ``scatter`` - expert inputs written by a scatter-add, outputs read back
                  by a gather: no dispatch products.
  * ``fused_combine`` (with ``einsum``) - the combine weights applied to the
                  expert activations before the ``w_out`` product, which
                  then contracts f and e at once.

Tokens are processed in groups of ``group_size`` (``min(group_size, T)``
for T tokens); the groups are a leading batch axis (G, g, d), each with
its own capacity C = ceil(g * top_k * cf / E), as under the reference's
``vmap``.  A choice past its expert's capacity is dropped (GShard): the
token keeps the other choices, or passes through the residual only.

Routing mirrors ``jax.lax.top_k``: equal logits go lowest expert first (a
stable descending sort, then its first k), and slots are given in
(token, choice) order, so earlier tokens keep theirs.  ``moe_ffn`` and
``moe_ffn_group`` take ``experts`` to run under given routes (the
gates still come from the call's own logits).  Every path that routes
(``moe_ffn_group``, the mesh plan ``parallel.Plan``) chooses through
``top_experts``, looked up in this module at each call: checks that
compare two paths wrap it to hold them under one set of routes, since a
last-bit difference in the router's input can flip a choice at a near
tie.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 512
    impl: str = "einsum"               # einsum | scatter
    router_mode: str = "topk_softmax"  # softmax over the selected logits
    # apply the combine weights before the w_out product (the reference's
    # reassociation for a tensor-parallel psum; one device computes the
    # same function in another order)
    fused_combine: bool = False


def capacity(cfg: MoEConfig) -> int:
    """Slots an expert has in one group."""
    c = int(np.ceil(cfg.group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(c, 1)


def router_logits(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., E), one product over the flattened tokens."""
    return (x.reshape(-1, x.shape[-1]) @ router_w).reshape(*x.shape[:-1], -1)


def top_experts(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest logits' experts, largest first, equal logits lowest
    expert first (``jax.lax.top_k``'s order)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]


def gates_of(logits: torch.Tensor, experts: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The gates of the chosen ``experts``, in the logits' dtype, from
    softmaxes in f32: over the chosen logits (``topk_softmax``) or over all
    experts (``softmax_topk``)."""
    if cfg.router_mode == "topk_softmax":
        gates = torch.softmax(torch.gather(logits, -1, experts).float(), dim=-1)
    else:
        gates = torch.gather(torch.softmax(logits.float(), dim=-1), -1, experts)
    return gates.to(logits.dtype)


def router_probs(logits: torch.Tensor, cfg: MoEConfig):
    """Top-k selection: (gates (..., k), experts (..., k) int64)."""
    experts = top_experts(logits, cfg.top_k)
    return gates_of(logits, experts, cfg), experts


def _positions_in_expert(experts: torch.Tensor, gates: torch.Tensor, cfg: MoEConfig):
    """Flatten each group's (g, k) choices; give each its slot in its
    expert, in (token, choice) order.  ``experts``, ``gates``: (..., g, k).
    Returns (..., g k) expert ids, slots, gates and the keep mask (slot <
    capacity)."""
    lead = experts.shape[:-2]
    flat_e = experts.reshape(*lead, -1)
    flat_gate = gates.reshape(*lead, -1)
    onehot = F.one_hot(flat_e, cfg.n_experts)                          # (..., gk, E)
    slot = torch.gather(onehot.cumsum(dim=-2), -1, flat_e[..., None])[..., 0] - 1
    return flat_e, slot, flat_gate, slot < capacity(cfg)


def _expert_ffn(w_gate, w_in, w_out, x):
    """SwiGLU experts: x (G, E, C, d), weights (E, d, f) / (E, f, d) ->
    (G, E, C, d), one batched product per weight over all groups."""
    G, E, C, d = x.shape
    xe = x.transpose(0, 1).reshape(E, G * C, d)
    a = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_in)
    return torch.bmm(a, w_out).reshape(E, G, C, -1).transpose(0, 1)


def moe_ffn_group(x: torch.Tensor, router_w, w_gate, w_in, w_out, cfg: MoEConfig,
                  experts: torch.Tensor | None = None) -> torch.Tensor:
    """Groups x (G, g, d) -> (G, g, d), each group routed on its own with
    ``cfg.group_size = g``.  ``experts`` (G, g, k): given routes in place of
    the top-k of the logits."""
    logits = router_logits(x, router_w)                                  # (G, g, E)
    if experts is None:
        experts = top_experts(logits, cfg.top_k)
    return expert_outputs(x, gates_of(logits, experts, cfg), experts, w_gate, w_in, w_out,
                          cfg)


def expert_outputs(x: torch.Tensor, gates, experts, w_gate, w_in, w_out, cfg: MoEConfig,
                   first: int = 0) -> torch.Tensor:
    """The routed tokens x (G, g, d) through the experts and combined by
    their ``gates`` (G, g, k), the routes ``experts`` (G, g, k) of every
    expert (the slots are counted over all of them).  ``w_gate`` (E', d,
    f'): the experts ``first .. first + E'`` alone (expert parallelism:
    the other experts' choices add nothing, and the output is this block's
    part of the sum), or all E of them (each may hold a slice of f)."""
    G, g, d = x.shape
    E, k, C = cfg.n_experts, cfg.top_k, capacity(cfg)
    flat_e, slot, flat_gate, keep = _positions_in_expert(experts, gates, cfg)
    safe_slot = torch.where(keep, slot, torch.zeros_like(slot))
    cell = flat_e * C + safe_slot                                        # (G, g k)
    weight = flat_gate * keep.to(flat_gate.dtype)
    n_loc = w_gate.shape[0]
    if n_loc != E:
        # another block's choices go to one spare cell past this block's, cut off after
        mine = (flat_e >= first) & (flat_e < first + n_loc)
        cell = torch.where(mine, cell - first * C, torch.full_like(cell, n_loc * C))
        keep = keep & mine
        weight = weight * mine.to(weight.dtype)
    cells = n_loc * C + (n_loc != E)

    if cfg.impl == "einsum":
        # a token's k choices name k different experts, so no two of them
        # write one (token, expert, slot): dropped ones write their 0 at slot 0
        idx = cell.reshape(G, g, k)
        zeros = x.new_zeros(G, g, cells)
        disp = zeros.scatter(-1, idx, keep.to(x.dtype).reshape(G, g, k))[..., :n_loc * C]
        comb = zeros.scatter(-1, idx, weight.reshape(G, g, k))[..., :n_loc * C]
        ex_in = torch.bmm(disp.transpose(1, 2), x).reshape(G, n_loc, C, d)  # gec,gd->ecd
        if cfg.fused_combine:
            xe = ex_in.transpose(0, 1).reshape(n_loc, G * C, d)
            a = (F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_in)).to(x.dtype)
            a = a.reshape(n_loc, G, C, -1).transpose(0, 1)               # (G, E, C, f)
            z = torch.matmul(comb.reshape(G, g, n_loc, C).transpose(1, 2), a)  # gec,ecf->egf
            return z.transpose(1, 2).reshape(G, g, -1) @ w_out.reshape(-1, d)
        ex_out = _expert_ffn(w_gate, w_in, w_out, ex_in).reshape(G, n_loc * C, d)
        return torch.bmm(comb, ex_out)                                   # gec,ecd->gd

    # scatter: each kept choice's token row added into its (expert, slot);
    # a dropped choice adds zeros at slot 0, as in the reference
    src = torch.where(keep[..., None], x.repeat_interleave(k, dim=1), x.new_zeros(()))
    rows = cell[..., None].expand(G, g * k, d)
    ex_in = x.new_zeros(G, cells, d).scatter_add(1, rows, src)[:, :n_loc * C]
    ex_out = _expert_ffn(w_gate, w_in, w_out, ex_in.reshape(G, n_loc, C, d)).reshape(
        G, n_loc * C, d)
    if cells != n_loc * C:
        ex_out = torch.cat([ex_out, ex_out.new_zeros(G, 1, d)], 1)
    contrib = (torch.gather(ex_out, 1, rows) * weight[..., None]).reshape(G, g, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):          # the reference's segment sum, in choice order
        out = out + contrib[:, :, j]
    return out


def group_size(cfg: MoEConfig, T: int) -> int:
    """The group of T tokens: ``min(group_size, T)``, which must divide T."""
    gsz = min(cfg.group_size, T)
    if T % gsz:
        raise ValueError(f"{T} tokens do not split into MoE groups of {gsz} "
                         f"(moe_group_size {cfg.group_size})")
    return gsz


def moe_ffn(x: torch.Tensor, router_w, w_gate, w_in, w_out, cfg: MoEConfig,
            experts: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., d): the leading dims flattened into T tokens, taken in groups
    of ``min(cfg.group_size, T)``.  ``experts`` (T, k): given routes."""
    d = x.shape[-1]
    T = x.numel() // d
    gsz = group_size(cfg, T)
    gcfg = dataclasses.replace(cfg, group_size=gsz)
    grouped = x.reshape(T // gsz, gsz, d)
    if experts is not None:
        experts = experts.reshape(T // gsz, gsz, cfg.top_k)
    return moe_ffn_group(grouped, router_w, w_gate, w_in, w_out, gcfg, experts).reshape(x.shape)


def route(x: torch.Tensor, router_w, cfg: MoEConfig) -> torch.Tensor:
    """The experts (T, k) that ``moe_ffn`` chooses for x (..., d)."""
    return top_experts(router_logits(x, router_w), cfg.top_k).reshape(-1, cfg.top_k)


def slots(experts: torch.Tensor, cfg: MoEConfig):
    """(slot, keep), each (T, k), of the routes ``experts`` (T, k) that
    ``moe_ffn`` would give them (groups of ``min(group_size, T)``)."""
    T, k = experts.shape
    gsz = group_size(cfg, T)
    grouped = experts.reshape(T // gsz, gsz, k)
    _, slot, _, keep = _positions_in_expert(grouped, grouped,
                                            dataclasses.replace(cfg, group_size=gsz))
    return slot.reshape(T, k), keep.reshape(T, k)


def load_balancing_loss(logits: torch.Tensor, experts: torch.Tensor, cfg: MoEConfig):
    """Switch-style aux loss: E * sum_e f_e * p_e (arXiv:2101.03961)."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_mean = probs.reshape(-1, cfg.n_experts).mean(0)
    counts = F.one_hot(experts.reshape(-1), cfg.n_experts).float().mean(0) * cfg.top_k
    return cfg.n_experts * torch.sum(p_mean * counts)
