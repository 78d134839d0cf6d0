"""Gradients of a loss over dicts of parameter tensors, whole-batch or
accumulated over microbatches.  Port of ``repro.optim.accumulate``.

``value_and_grad(loss_fn)`` is the counterpart of ``jax.value_and_grad``
for ``loss_fn(params, *args) -> scalar``.  ``gradient_accumulation``
trades activation memory for steps: the batch's leading axis is split as
the JAX function splits it (``microbatch``), and a Python loop takes the
place of ``lax.scan``.  On a mesh the LM step accumulates each position's
gradient blocks over its replica's microbatches
(``models.transformer.parallel.Plan.grads``).
"""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map


def _rebuild(tree, leaves):
    """``tree``'s nested dicts with ``leaves`` in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def value_and_grad(loss_fn, on_forward=None):
    """``fn(params, *args) -> (loss, grads)``: the loss detached, and its
    gradient in every leaf of ``params`` (nested dicts of float tensors),
    as a dict of the same keys.  ``params`` are not modified.
    ``on_forward()``, when given, is called between the forward and the
    backward pass (a caller's timer)."""

    def fn(params, *args, **kwargs):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = _rebuild(params, iter(leaves))
        with torch.enable_grad():
            loss = loss_fn(live, *args, **kwargs)
            if on_forward is not None:
                on_forward()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), _rebuild(params, iter(grads))

    return fn


def microbatch(x: torch.Tensor, n_micro: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n_micro`` of ``x``'s leading axis, as the JAX
    function splits it: ``(B, ...) -> (B/n, n, ...)``, then ``[:, i]`` (so a
    data replica's block of rows holds its share of every microbatch)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"{b} rows do not split into {n_micro} microbatches")
    return x.reshape(b // n_micro, n_micro, *x.shape[1:])[:, i]


def gradient_accumulation(loss_fn, n_micro: int):
    """``loss_fn(params, batch) -> scalar``.  Returns ``grad_fn(params,
    batch) -> (loss, grads)``, the mean over ``n_micro`` microbatches."""

    vg = value_and_grad(loss_fn)

    def grad_fn(params, batch):
        tot_l = torch.zeros((), device=tree_leaves(params)[0].device)
        tot_g = tree_map(torch.zeros_like, params)
        for i in range(n_micro):
            loss, g = vg(params, tree_map(lambda x: microbatch(x, n_micro, i), batch))
            tot_g = tree_map(torch.add, tot_g, g)
            tot_l = tot_l + loss
        inv = 1.0 / n_micro
        return tot_l * inv, tree_map(lambda g: g * inv, tot_g)

    return grad_fn
