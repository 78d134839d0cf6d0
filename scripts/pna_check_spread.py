"""The shard-train phase's partitioned-PNA gradient check, repeated, leaf by
leaf: with torch's default ``index_add_`` (float atomics on a card, adding
in any order) and under ``launch.train.deterministic()``.

    python3 scripts/pna_check_spread.py [--device cuda] [--repeats 10]

It builds the inputs of ``chip_smoke.part_gnn_check`` at ``chip_smoke.FULL``
(PNA at ``make_config()`` widths on ``full_graph_sm``, four shards of the
one-process mesh on the device) and runs, ``--repeats`` times in each
mode, the check's three f32 gradients: the whole graph, the whole graph
with its node features one ulp up, and the partitioned graph.  A leaf's
ratio is its error against the check's bound, ``1e-4 max|g| + 2 spread``
(``spread``: the nudged whole graph's distance from the whole graph).
Each run prints its worst leaf, whether it is bitwise the run before, and
for the first run of each mode the six worst leaves."""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def inputs(dev, sz):
    mesh = cs.make_host_mesh(sz.shards, device=dev)
    D = mesh.shape["model"]
    shape = next(s for s in cs.pna_cfg.SHAPES if s.name == "full_graph_sm")
    cfg32 = dataclasses.replace(cs.pna_cfg.shape_config(sz.gnn_make(), shape),
                                compute_dtype=torch.float32)
    n, E = cs.steps.gnn_sizes(shape)
    N_p = -(-n // D) * D
    rng = np.random.default_rng(sz.gnn_seed)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    label_mask = np.zeros(N_p, np.float32)
    label_mask[:n] = 1
    nodes = {"node_feat": rng.standard_normal((N_p, cfg32.d_feat), dtype=np.float32),
             "labels": rng.integers(0, cfg32.n_classes, N_p).astype(np.int32),
             "label_mask": label_mask}
    part, _ = cs.sampler.partition_graph(src, dst, N_p, D)
    whole = train.to_device(dict(nodes, edge_src=src, edge_dst=dst,
                                 edge_mask=np.ones(E, np.float32)), dev)
    pbatch = train.to_device(dict(nodes, **part), dev)
    params = cs.pna.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    return mesh, cfg32, whole, pbatch, params


def one_run(mesh, cfg32, whole, pbatch, params):
    grad = cs.optim.value_and_grad
    feat = whole["node_feat"]
    nudged = dict(whole, node_feat=torch.nextafter(feat, torch.full_like(feat, np.inf)))
    _, gw = grad(cs.pna.loss)(params, cfg32, whole)
    _, gn = grad(cs.pna.loss)(params, cfg32, nudged)
    _, gg = grad(lambda p, c, b: cs.pna.loss_partitioned(p, c, b, mesh=mesh))(
        params, cfg32, pbatch)
    leaves = cs.optim.optimizers.tree_leaves
    rows = []
    for i, (a, b, c) in enumerate(zip(leaves(gg), leaves(gw), leaves(gn))):
        err, top = float((a - b).abs().max()), float(b.abs().max())
        spread = float((c - b).abs().max())
        rows.append((i, err, top, spread, err / (1e-4 * top + 2 * spread + 1e-30)))
    return rows, [x.clone() for x in leaves(gw) + leaves(gg)]


def report(tag, repeats, args):
    worst, before = [], None
    for r in range(repeats):
        rows, grads = one_run(*args)
        w = max(rows, key=lambda t: t[4])
        worst.append(w[4])
        same = None if before is None else all(map(torch.equal, grads, before))
        before = grads
        print(f"{tag} run {r}: worst leaf {w[0]} error {w[1]:.3g}, largest entry {w[2]:.3g}, "
              f"spread {w[3]:.3g}, {w[4]:.3f} of its bound; bitwise the run before: {same}",
              flush=True)
        if r == 0:
            for t in sorted(rows, key=lambda t: -t[4])[:6]:
                print(f"   leaf {t[0]}: error {t[1]:.3g} ({t[1] / max(t[2], 1e-30):.3g} of its "
                      f"largest entry {t[2]:.3g}), spread {t[3]:.3g}, {t[4]:.3f} of its bound",
                      flush=True)
    print(f"{tag}: worst leaf's share of its bound, run by run: "
          + " ".join(f"{x:.3f}" for x in worst), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=10)
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = inputs(torch.device(a.device), cs.FULL)
    report("default", a.repeats, args)
    with train.deterministic():
        report("deterministic", max(2, a.repeats // 3), args)


if __name__ == "__main__":
    main()
