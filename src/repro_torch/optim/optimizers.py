"""Optimizers as (init, update) pairs over dicts of tensors.  Port of
``repro.optim.optimizers``.

``update(grads, state, params, lr) -> (params, state)``; ``lr`` is a float
or a 0-d tensor (schedules produce it per step).  States are dicts that
match ``params`` leaf for leaf (plus adamw's int32 step ``t``), so a
checkpoint writes them under the JAX package's key paths (``acc/...``,
``m/...``, ``v/...``, ``t``).

Where the JAX functions return new trees, these update ``params`` and
``state`` in place, under ``torch.no_grad()``, and return the same dicts:
at full width the embedding arena is 2.11 GB, and a copy of it every
step would double the step's traffic.  Each update keeps the JAX
formula and its order of operations, so the two packages agree to the
last bits or nearly: ``acc + g*g``, then ``p - (lr*g) / (sqrt(acc) + eps)``.
``torch.optim`` is not used: its Adagrad places ``eps`` and the initial
accumulator differently.

Each update runs over a leaf in blocks of at most ``BLOCK`` elements
(``_blocks``), so that its temporaries (``g * g``, ``lr * g``,
``sqrt(acc)``, ...) never take the size of a whole leaf: a full-width
Wide&Deep arena is 16.3 GB, and two such temporaries beside the params,
the accumulator and the gradient would not fit on an 80 GB card.  The
operations are elementwise, so the result is bitwise the whole-leaf form.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


BLOCK = 1 << 26      # elements of a leaf updated at once (256 MiB of f32)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted key order: the order of
    ``jax.tree.leaves`` for dicts, so that sums over leaves add in the same
    order in both packages."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / |grads|), |grads|)``: new tensors, the
    norm over every leaf in f32."""
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


def apply_weight_decay(params, updates, weight_decay: float, lr):
    if weight_decay == 0.0:
        return updates
    return tree_map(lambda u, p: u + weight_decay * lr * p, updates, params)


def _blocks(*leaves):
    """Matching flat views, at most ``BLOCK`` elements each, of tensors of
    one shape (the whole tensors when they are no larger): an in-place
    update of a view writes its leaf.  A larger leaf that is not contiguous
    goes one index of its first dim at a time."""
    n = leaves[0].numel()
    if n <= BLOCK:
        yield leaves
        return
    if not all(t.is_contiguous() for t in leaves):
        # a position's block of a leaf (a mesh's column block): one index of
        # its first dim at a time
        for i in range(leaves[0].shape[0]):
            yield from _blocks(*(t[i] for t in leaves))
        return
    flat = [t.view(-1) for t in leaves]
    for i in range(0, n, BLOCK):
        yield [f[i:i + BLOCK] for f in flat]


def _blockwise(fn):
    """``fn`` over the matching blocks of its leaves."""
    def run(*leaves):
        for parts in _blocks(*leaves):
            fn(*parts)
    return run


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mom": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if momentum == 0.0:
            tree_map(_blockwise(lambda p, g: p.sub_(lr * g)), params, grads)
            return params, state

        @_blockwise
        def upd(p, m, g):
            m.mul_(momentum).add_(g)
            p.sub_(lr * m)

        tree_map(upd, params, state["mom"], grads)
        return params, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: float | None = 1.0) -> Optimizer:
    def init(params):
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=_device(params)),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        state["t"].add_(1)
        t = state["t"].float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        @_blockwise
        def upd(p, m, v, g):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p
            p.sub_(lr * step)

        tree_map(upd, params, state["m"], state["v"], grads)
        return params, state

    return Optimizer(init, update)


def adagrad(eps: float = 1e-10, init_acc: float = 0.1) -> Optimizer:
    """Classic per-coordinate Adagrad, the production recsys default:
    rarely seen embedding rows keep a high learning rate."""

    def init(params):
        return {"acc": tree_map(lambda p: torch.full_like(p, init_acc), params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        @_blockwise
        def upd(p, g, a):
            a.add_(g * g)
            p.sub_((lr * g).div_(torch.sqrt(a).add_(eps)))

        tree_map(upd, params, grads, state["acc"])
        return params, state

    return Optimizer(init, update)
