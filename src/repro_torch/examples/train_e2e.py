"""End-to-end driver: train a ~100M-parameter DPLR-FwFM for a few hundred
steps on the synthetic CTR stream, with the whole training substrate:
the prefetching pipeline, Adagrad, asynchronous checkpoints and eval.
Port of the JAX package's ``examples/train_e2e.py``: its flags (plus
``--device``), layout and settings.

~100M params: a 5.44M-row embedding arena (the reference's docstring
says 5.9M; its vocabularies, kept here, sum to 5,437,400) x (16-dim
embedding + 1 first-order weight), 92M in all, the paper's CTR geometry
(82 fields, 44 context / 38 item), rank 3, B = 2,048, lr 0.05, a
checkpoint every 50 steps (the newest two kept), AUC on 20,000 held-out
rows.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--steps 300] \\
        [--ckpt-dir D] [--resume] [--device cpu]

Runs on the card unless ``--device`` names another device; there every
field lookup is the embedding-bag kernel and its backward the
bag-backward kernel.  ``--ckpt-dir`` defaults to ``repro_torch_e2e_ckpt``
in the temporary directory; checkpoints are the JAX package's format.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.fields import uniform_layout
from repro_torch.data.pipeline import ShardedPipeline
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.examples.quickstart import auc
from repro_torch.launch.train import to_device, train_step
from repro_torch.models.recsys import fwfm

# 82 fields; big id fields push the arena to 5.44M rows -> 92M params
VOCABS = [2_000_000, 1_000_000] + [500_000] * 4 + [50_000] * 8 + [1_000] * 34 + [100] * 34


def make_layout():
    return uniform_layout(44, 38, VOCABS)


def make_data(layout):
    return SyntheticCTR(layout, embed_dim=4, teacher_rank=3, noise_scale=0.3, zipf_alpha=1.3,
                        seed=0)


def run(layout, steps=300, batch=2048, ckpt_dir=None, resume=False, device=None,
        params=None, ckpt_every=50) -> dict:
    """Train on ``layout`` (the reference's by default; a test passes a
    narrow one) from ``params`` (default ``fwfm.init`` from seed 0), with a
    checkpoint every ``ckpt_every`` steps in ``ckpt_dir``, resuming from
    its newest with ``resume``.  Returns ``{"losses": {step: loss},
    "params", "auc", "start", "logits"}``."""
    dev = resolve_device(device)
    cfg = fwfm.FwFMConfig(layout=layout, embed_dim=16, interaction="dplr", rank=3)
    if params is None:
        params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in params.values())
    print(f"model: {n_params/1e6:.1f}M parameters ({layout.total_vocab/1e6:.1f}M arena "
          f"rows, {layout.n_fields} fields)", flush=True)

    data = make_data(layout)
    opt = optim.adagrad()
    state = opt.init(params)
    mgr = CheckpointManager(ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                     "repro_torch_e2e_ckpt"), keep=2)
    start = 0
    if resume:
        restored, step0 = mgr.restore({"params": params, "opt": state}, device=dev)
        if restored:
            params, state, start = restored["params"], restored["opt"], step0
            print(f"resumed from step {step0}", flush=True)

    pipe = ShardedPipeline(lambda s: data.batch(batch, s), prefetch=2).start(from_step=start)
    losses = {}
    t0 = time.time()
    try:
        for s in range(start, steps):
            _, b = pipe.get()
            loss, params, state = train_step(fwfm, cfg, opt, params, state,
                                             to_device(b, dev), 0.05)
            losses[s + 1] = loss.detach()
            if (s + 1) % ckpt_every == 0:
                rate = batch * (s + 1 - start) / (time.time() - t0)
                print(f"step {s+1:4d}  loss {float(loss):.4f}  {rate/1e3:.1f}k rows/s",
                      flush=True)
                mgr.save({"params": params, "opt": state}, s + 1)
    finally:
        pipe.stop()
        mgr.wait()

    # eval
    ev = data.batch(20000, 10**6)
    with torch.no_grad():
        logits = fwfm.apply(params, cfg, to_device(ev, dev)).cpu().numpy()
    value = auc(ev["label"], logits)
    print(f"eval AUC: {value:.4f}", flush=True)
    return {"losses": {s: float(v) for s, v in losses.items()}, "params": params,
            "auc": value, "start": start, "logits": logits}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_e2e_ckpt in the "
                         "temporary directory)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return run(make_layout(), args.steps, args.batch, args.ckpt_dir, args.resume, args.device)


if __name__ == "__main__":
    main()
