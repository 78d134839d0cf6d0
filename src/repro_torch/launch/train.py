"""Fault-tolerant training entry point of the port.  Port of
``repro.launch.train`` for the recsys and lm families on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dplr-fwfm \
        --steps 300 --batch 4096 --ckpt-dir /tmp/ckpt [--resume] [--device cuda]

  * checkpoint/restart: async atomic checkpoints every --ckpt-every steps,
    in the JAX package's format (``repro_torch.checkpoint``); on start
    with --resume, the newest valid checkpoint is restored and the data
    pipeline resumes at the restored step.  Batches are a pure function
    of (seed, step), and every operation of a step, the kernels' backward
    included, sums in a fixed order, so a resumed run repeats the
    uninterrupted run bitwise.  The lm trainer's module asks for its step
    to run under ``torch.use_deterministic_algorithms(True)``
    (``deterministic``): the embedding gather's backward then sums each
    row in a fixed order on the card instead of with atomics.
  * preemption simulation: --fail-at N hard-exits (code 42) after step N;
    rerunning with --resume continues.
  * straggler mitigation: bounded prefetch (``data.pipeline``).

A step is ``value_and_grad(mod.loss)`` and then the optimizer (adagrad
for recsys, adamw for lm), as ``repro.launch.train``'s, for every recsys
architecture of the registry (``dplr-fwfm``, ``wide-deep``, ``autoint``,
``bst``, ``mind``) and every lm one (``gemma3-1b``, ``starcoder2-7b``,
``yi-9b``, and the mixture-of-experts ``granite-moe-1b-a400m`` and
``mixtral-8x7b``: ``model.lm_loss`` on zipf tokens, ``--seq`` positions;
an MoE model needs ``--batch`` x ``--seq`` a multiple of its
``moe_group_size`` when it exceeds it).  On
the card the recsys loss runs the ``embedding_bag`` kernel forward and
its deterministic backward kernel for the field lookups and the history,
target and negative gathers, and the ``fwfm_pairwise`` kernel forward for
a full-FwFM model; the lm loss attends through the plain
``gqa_attention``, as the JAX loss does.  The gnn family trains through
``python -m repro_torch.examples.gnn_train``, as the JAX driver sends it
to its ``examples/gnn_train.py``.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import REGISTRY
from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.models.recsys import autoint, bst, fwfm, mind, wide_deep
from repro_torch.models.transformer import model as tm
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sharding import collectives, rules

_RECSYS_MODULES = {"dplr-fwfm": fwfm, "wide-deep": wide_deep, "autoint": autoint,
                   "bst": bst, "mind": mind}


def recsys_module(name: str):
    """The model module of a recsys architecture of the registry."""
    return _RECSYS_MODULES[name]


def _histories(cfg, batch_size: int, seed: int, step: int, targets: bool) -> dict:
    """The JAX trainer's behaviour histories for BST and MIND, and MIND's
    targets and negatives: uniform item ids from
    ``default_rng((seed, 3, step))``, drawn in its order."""
    rng = np.random.default_rng((seed, 3, step))
    item_vocab = cfg.layout.fields[-1].vocab_size
    out = {
        "hist_ids": rng.integers(0, item_vocab, (batch_size, cfg.seq_len)).astype(np.int32),
        "hist_mask": np.ones((batch_size, cfg.seq_len), np.float32),
    }
    if targets:
        out["target_id"] = rng.integers(0, item_vocab, batch_size).astype(np.int32)
        out["neg_ids"] = rng.integers(0, item_vocab, (batch_size, cfg.n_neg)).astype(np.int32)
    return out


def build_recsys_trainer(arch_name: str, cfg, batch_size: int, seed: int):
    """(model module, ``make_batch(step) -> numpy batch``) on the JAX
    trainer's data, one batch per (seed, step): ``SyntheticCTR`` rows with
    a rank-2 teacher, plus the histories of ``_histories`` for ``bst``;
    for ``mind`` the histories, targets and negatives alone (the JAX
    trainer builds a ``SyntheticCTR`` for it too and never reads it; at
    full width that is ~4e8 normal draws, so none is built here)."""
    mod = _RECSYS_MODULES[arch_name]
    if arch_name == "mind":
        return mod, lambda step: _histories(cfg, batch_size, seed, step, targets=True)
    data = SyntheticCTR(cfg.layout, embed_dim=min(cfg.embed_dim, 8), teacher_rank=2,
                        seed=seed)

    def make_batch(step):
        b = data.batch(batch_size, step)
        if arch_name == "bst":
            b.update(_histories(cfg, batch_size, seed, step, targets=False))
        return b

    return mod, make_batch


def lm_tokens(cfg, batch_size: int, seq: int, seed: int, step: int) -> dict:
    """The JAX trainer's LM batch for one (seed, step): zipf(1.2) draws
    from ``default_rng((seed, step))``, shifted to 0 and wrapped into the
    vocabulary, ``tokens`` the first ``seq`` and ``labels`` the last
    ``seq`` of each row of ``seq + 1``."""
    rng = np.random.default_rng((seed, step))
    toks = (rng.zipf(1.2, (batch_size, seq + 1)) - 1) % cfg.vocab
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def build_lm_trainer(arch_name: str, cfg, batch_size: int, seq: int, seed: int, device):
    """(model module, ``make_batch(step) -> numpy batch``) for an lm
    architecture of the registry, as ``repro.launch.train``'s; the
    module's ``loss`` is ``lm_loss`` on ``device``, and its
    ``deterministic`` makes ``train_step`` run under ``deterministic()``."""
    mod = SimpleNamespace(init=tm.init,
                          loss=lambda p, c, b: tm.lm_loss(p, c, b, device=device),
                          deterministic=True)
    return mod, lambda step: lm_tokens(cfg, batch_size, seq, seed, step)


# the cuBLAS workspace that torch's deterministic mode asks for
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the duration (an
    operation without a deterministic implementation raises), restored
    after.  Where ``CUBLAS_WORKSPACE_CONFIG`` is unset, it is
    ``CUBLAS_WORKSPACE`` for the duration, as torch's check on a cuBLAS
    call asks.  ``main`` sets it for the lm family before CUDA starts, so
    that every cuBLAS workspace of the run has that size."""
    was = torch.are_deterministic_algorithms_enabled()
    unset = "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    if unset:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if unset:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_step(mod, cfg, optimizer, params, opt_state, batch, lr, mark=None):
    """One step: the loss and its gradient in every parameter, then the
    optimizer's in-place update.  Returns (loss, params, opt_state).
    ``mark(name)``, when given, is called after "forward", "backward" and
    "update" (a caller's timer).  A module whose ``deterministic`` is
    true (the lm trainer's) runs the step under ``deterministic()``."""
    on_forward = None if mark is None else (lambda: mark("forward"))
    with deterministic() if getattr(mod, "deterministic", False) else contextlib.nullcontext():
        loss, grads = optim.value_and_grad(mod.loss, on_forward=on_forward)(params, cfg, batch)
        if mark is not None:
            mark("backward")
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
    if mark is not None:
        mark("update")
    return loss, params, opt_state


def _split(tree: dict, specs: dict, keep) -> dict:
    """``keep(leaf, spec)`` over a tree of dicts and its rules; leaves for
    which it gives None are left out."""
    out = {}
    for k, v in tree.items():
        got = _split(v, specs[k], keep) if isinstance(v, dict) else keep(v, specs[k])
        if got is not None and not (isinstance(got, dict) and not got):
            out[k] = got
    return out


def _model_split(spec) -> bool:
    return any("model" in rules.entry_axes(e) for e in spec)


def _mirrored(inputs: dict) -> bool:
    """Whether the first data replica runs for all: on ``meta``, where the
    work is counted, not done."""
    return any(v.is_meta for v in inputs.values())


def each_replica(fn, mesh, inputs: dict, specs: dict) -> tuple[list, int]:
    """``fn(rows, replica)`` on each data replica's rows of ``inputs``
    (``specs``: each leaf's rule), at the replica's first position.
    Returns (outputs, ran): one output a replica, or one alone where no
    leaf splits over a data axis (every replica would compute the same);
    ``ran`` replicas ran.  On ``meta`` the first replica runs for all, the
    others' outputs its own (``collectives.mirror``): 512 positions stay
    quick to count."""
    split = mesh.dp > 1 and any(e is not None for spec in specs.values() for e in spec)
    ran = 1 if not split or _mirrored(inputs) else mesh.dp
    if ran < mesh.dp:
        collectives.mirror(mesh)
    outs = []
    for r in range(ran):
        sub = mesh.replica(r)
        first = sub.coords(0)
        rows = {k: rules.local_block(v, specs[k], mesh, first) for k, v in inputs.items()}
        with collectives.at(first):
            outs.append(fn(rows, sub))
    return [outs[r % ran] for r in range(mesh.dp if split else 1)], ran


def data_parallel_grads(mod, cfg, params, batch, *, mesh, batch_specs: dict):
    """(loss, grads, ran): the first two stages of ``data_parallel_step``,
    the gradients the mean over the data axes (every position's copy
    alike; the first replica's returned), ``ran`` as ``each_replica``."""
    from repro_torch.embedding.sharded import make_sharded_take

    def replica_grads(rows, sub):
        take = make_sharded_take(sub)
        return optim.value_and_grad(lambda p, c, b: mod.loss(p, c, b, take_fn=take))(
            params, cfg, rows)

    outs, ran = each_replica(replica_grads, mesh, batch, batch_specs)
    pspecs = rules.recsys_param_specs(params, mesh)
    # the mean over the data axes, in position order, into the first
    # replica's gradients
    firsts = [mesh.replica(r).coords(0) for r in range(len(outs))]
    loss = collectives.all_reduce([o[0] for o in outs], firsts, "mean")[0]
    grads = outs[0][1]
    for (path, leaf), (_, spec) in zip(_leaves(grads), _leaves(pspecs)):
        if _model_split(spec):
            for s in range(mesh.shape["model"]):
                group = [mesh.replica(r).coords(s) for r in range(len(outs))]
                block = [rules.local_block(_get(o[1], path), spec, mesh, mesh.coords(s))
                         for o in outs]
                collectives.all_reduce(block, group, "mean", out=block[0])
                collectives.hold(block[0], group[1:])
        else:
            collectives.all_reduce([_get(o[1], path) for o in outs], firsts, "mean", out=leaf)
            collectives.hold(leaf, firsts[1:])
            for r in range(ran):
                sub = mesh.replica(r)
                collectives.broadcast(leaf, sub.positions(), sub.devices)
    return loss, grads, ran


def data_parallel_step(mod, cfg, optimizer, params, opt_state, batch, lr, *, mesh,
                       batch_specs: dict):
    """One recsys step on a mesh with data replicas, the port's counterpart
    of the step the reference's GSPMD derives from its rules.  Returns
    (loss, params, opt_state), the parameters and state updated in place.

    * Each data replica (``mesh.replica(r)``) takes its rows of the batch
      (``batch_specs``: each leaf's rule, ``steps.auto_batch_specs``;
      ``each_replica``), and computes its loss and gradients at its first
      position, every arena lookup through
      ``embedding.sharded.make_sharded_take`` on its model axis (kernels 5
      and 5' on each of its blocks).
    * The mean over the data axes (equal shares: the mean over the whole
      batch, as GSPMD's): the losses and every gradient all-reduced in
      position order (``sharding.collectives``), an arena leaf block by
      block over its model position's data group, a replicated leaf over
      the replicas' first positions and then sent on to the others of
      each replica.  The arena's all-reduce of the dense block gradient is
      the step's largest collective.
    * The optimizer's update at each position of its blocks
      (``sharding.rules.recsys_param_specs``: the arena's rows at its model
      coordinate, the dense leaves whole).

    ``params`` and ``opt_state`` are one copy, which every replica reads
    (their values are alike).  On ``meta`` every position updates its
    blocks, so that a count (``launch.cost.analyze(mesh=)``) sees each
    device's work; on a real device each block, and each replicated leaf,
    is updated once.  On ``meta`` the first replica runs for all, and with
    a batch that splits over no data axis the first alone runs
    (``each_replica``).  With one data replica the step is ``train_step``
    with ``take_fn``, bitwise.  The optimizer's state must mirror the
    parameters (adagrad's ``acc``; sgd's ``mom``)."""
    if set(opt_state) - {"acc", "mom"}:
        raise ValueError(f"state {sorted(opt_state)}: the data-parallel step updates state "
                         f"that mirrors the parameters only")
    loss, grads, ran = data_parallel_grads(mod, cfg, params, batch, mesh=mesh,
                                           batch_specs=batch_specs)
    pspecs = rules.recsys_param_specs(params, mesh)
    update_all = tree_leaves(params)[0].device.type == "meta"
    for r in range(ran) if update_all else [0]:
        for s, pos in enumerate(mesh.replica(r).positions()):
            def mine(leaf, spec, pos=pos, s=s):
                if _model_split(spec):
                    return rules.local_block(leaf, spec, mesh, pos)
                return leaf if update_all or s == 0 else None

            local = lambda tree: _split(tree, pspecs, mine)                     # noqa: E731
            with collectives.at(pos):
                optimizer.update(local(grads), {k: local(v) for k, v in opt_state.items()},
                                 local(params), lr)
    return loss, params, opt_state


# the LM cells' adamw clips the gradient's global norm at 1 (``optim.adamw``)
LM_CLIP_NORM = 1.0


def lm_data_parallel_step(plan, optimizer, params, opt_state, batch, lr, n_micro: int):
    """One LM step of ``plan`` (``models.transformer.parallel.Plan``: a
    config on a mesh), the port's counterpart of the step GSPMD derives
    from ``rules.lm_param_specs``.  Returns (loss, params, opt_state), the
    parameters and state updated in place.

    * Each position takes its replica's rows of ``batch`` (``tokens``,
      ``labels``; ``rules.lm_batch_spec``) and runs ``n_micro`` microbatches
      of them (``Plan.grads``): the gradients of its blocks, accumulated
      over the microbatches in blocks of its own.
    * The mean over the data replicas: a leaf's gradient is all-reduced
      over the data axes it does not split over (every one without FSDP;
      with FSDP the gather's backward has reduce-scattered it over
      ``data`` already, each microbatch), in position order, then divided
      by their number.
    * adamw's global-norm clip at ``LM_CLIP_NORM``
      (``optim.clip_by_global_norm``'s formula): the squared norms of each position's blocks all-reduced
      over the axes the leaves split over, a replicated leaf counted once.
    * ``optimizer`` (an adamw without its own clip) at each position on
      its blocks of the parameters and of ``m``/``v``; the step count
      advances once.  On a real device each block is updated once, by the
      first position that holds it; on ``meta`` every counted position
      updates its blocks.

    Runs under ``deterministic()``, as the one-device LM step does."""
    with deterministic():
        loss, flat = lm_data_parallel_grads(plan, params, batch, n_micro)
        specs = tree_leaves(plan.specs)
        flat = _clip_blocks(plan, flat, specs, LM_CLIP_NORM)
        _update_blocks(plan, optimizer, flat, specs, params, opt_state, lr)
    return loss, params, opt_state


def lm_data_parallel_grads(plan, params, batch, n_micro: int):
    """(loss, grads): the first two stages of ``lm_data_parallel_step``,
    ``grads`` each running position's gradient blocks (``rules.lm_param_specs``
    leaves in ``tree_leaves`` order) after the mean over the data replicas."""
    mesh = plan.mesh
    plan.mirror()
    spec = rules.lm_batch_spec(mesh)
    rows = {k: [rules.local_block(batch[k], spec, mesh, p) for p in plan.pos]
            for k in ("tokens", "labels")}
    dp_axes = rules.dp_axes(mesh)
    losses, grads = plan.grads(params, rows["tokens"], rows["labels"], n_micro)
    flat = [tree_leaves(g) for g in grads]
    for li, sp in enumerate(tree_leaves(plan.specs)):
        split = {a for e in sp for a in rules.entry_axes(e)}
        rest = tuple(a for a in dp_axes if a not in split)
        gs = [f[li] for f in flat]
        if math.prod(mesh.shape[a] for a in rest) > 1:
            gs = plan.over(rest, collectives.all_reduce, gs)
        if mesh.dp > 1:
            gs = plan.each(lambda i, g: g / mesh.dp, gs)
        for f, g in zip(flat, gs):
            f[li] = g
    loss = plan.over(dp_axes, collectives.all_reduce, losses, op="mean")[0] \
        if mesh.dp > 1 else losses[0]
    return loss, flat


def _clip_blocks(plan, flat: list, specs: list, max_norm: float) -> list:
    """Each position's gradient blocks scaled by ``min(1, max_norm / |g|)``,
    ``|g|`` the norm over every leaf of the whole gradient."""
    kinds = [("model" in a, "data" in a) for a in
             ({x for e in sp for x in rules.entry_axes(e)} for sp in specs)]

    def squares(i, fl, want):
        return sum((torch.sum(g.float() ** 2) for g, kind in zip(fl, kinds) if kind == want),
                   torch.zeros((), device=fl[0].device))

    total = plan.each(lambda i, fl: squares(i, fl, (False, False)), flat)
    for want, axes in (((True, False), "model"), ((True, True), ("data", "model"))):
        part = plan.over(axes, collectives.all_reduce,
                         plan.each(lambda i, fl, w=want: squares(i, fl, w), flat))
        total = plan.each(lambda i, t, p: t + p, total, part)

    def scaled(i, fl, sq):
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        return [(g * scale).to(g.dtype) for g in fl]

    return plan.each(scaled, flat, total)


def _update_blocks(plan, optimizer, flat: list, specs: list, params, opt_state, lr) -> None:
    mesh = plan.mesh
    leaves = {k: tree_leaves(params if k == "p" else opt_state[k]) for k in ("p", "m", "v")}
    t0 = opt_state["t"].clone()
    seen, first = set(), True
    for i, p in enumerate(plan.pos):
        mine = []
        for li, sp in enumerate(specs):
            key = (li, tuple(rules.block_index(e, mesh, p)[0] for e in sp))
            if plan.meta or key not in seen:
                seen.add(key)
                mine.append(li)
        if not mine:
            continue

        def local(name):
            return {str(li): rules.local_block(leaves[name][li], specs[li], mesh, p)
                    for li in mine}

        state = {"m": local("m"), "v": local("v"), "t": opt_state["t"] if first else t0.clone()}
        first = False
        with collectives.at(p):
            optimizer.update({str(li): flat[i][li] for li in mine}, state, local("p"), lr)


def _leaves(tree, prefix=()):
    """(path, leaf) of nested dicts in ``tree_leaves`` order (a rule's
    tuple is a leaf)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dplr-fwfm")
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default=None, choices=[None, "adagrad", "adamw"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate preemption: hard-exit at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = REGISTRY[args.arch]
    if spec.family not in ("recsys", "lm"):
        raise SystemExit("use python -m repro_torch.examples.gnn_train for the gnn family")
    cfg = spec.make_smoke() if args.config == "smoke" else spec.make_config()
    lm = spec.family == "lm"
    if lm:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if lm:
        mod, make_batch = build_lm_trainer(args.arch, cfg, args.batch, args.seq, args.seed,
                                           dev)
    else:
        mod, make_batch = build_recsys_trainer(args.arch, cfg, args.batch, args.seed)
    opt_name = args.optimizer or ("adamw" if lm else "adagrad")
    optimizer = optim.adagrad() if opt_name == "adagrad" else optim.adamw()

    params = mod.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    opt_state = optimizer.init(params)
    start_step = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume:
            restored, step = mgr.restore({"params": params, "opt": opt_state}, device=dev)
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                start_step = step
                print(f"resumed from step {step}")

    pipe = ShardedPipeline(make_batch, prefetch=2).start(from_step=start_step)
    losses = []
    step_reached = start_step      # last step whose update actually landed
    last_saved = start_step if start_step else None
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            _, batch = pipe.get()
            loss, params, opt_state = train_step(mod, cfg, optimizer, params, opt_state,
                                                 to_device(batch, dev), args.lr)
            losses.append(float(loss))
            step_reached = step + 1
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save({"params": params, "opt": opt_state}, step + 1)
                last_saved = step + 1
            if args.fail_at is not None and step + 1 == args.fail_at:
                print(f"[simulated preemption at step {step + 1}]", flush=True)
                os._exit(42)
            if not args.quiet and (step + 1) % args.log_every == 0:
                rate = (step + 1 - start_step) / (time.time() - t0)
                print(f"step {step+1:5d} loss {float(loss):.5f} "
                      f"({rate:.1f} steps/s)", flush=True)
    finally:
        pipe.stop()
        # save at the step the loop reached: labelling a partial run as
        # --steps would make --resume restore past the end
        if mgr and step_reached > start_step and step_reached != last_saved:
            mgr.save({"params": params, "opt": opt_state}, step_reached)
        if mgr:
            mgr.wait()
    if losses:
        print(f"final loss: {losses[-1]:.5f}")
    else:
        print(f"no steps to run: resumed at step {start_step} of {args.steps}")
    return losses


if __name__ == "__main__":
    main()
