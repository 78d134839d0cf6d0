"""Dry run: build every (architecture x shape) cell on ``meta`` and count
its work and memory, without allocating or launching anything: on one
card, or a device of the production meshes (``--mesh``).  The port's
counterpart of ``repro.launch.dryrun``, which compiles each cell for the
TPU pod meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # every cell, one card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch dplr-fwfm
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --arch mixtral-8x7b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --force       # recount

Each cell is ``launch.steps.build(arch, shape, device="meta")`` counted by
``launch.cost.analyze``.  One JSON file a cell, under
``results/dryrun_torch/<arch>__<shape>.json`` (``--out`` names another
directory), so a run that stops resumes where it stopped; ``--force``
counts again.  A record holds the parameter, optimizer-state and input
bytes, ``flops``, ``bytes``, ``peak_bytes`` (arguments included), each
kernel's counted work, the seconds the count took, the cell's ``notes``,
and whether it fits one card: ``peak_bytes`` against the card's memory
(``--card-bytes``; default the first card's ``total_memory`` where one
is present, else 80 GB, an H100's, and the record says which).  A cell
that cannot build records why.  ``--opt partitioned`` counts PNA's
node-task shapes as ``+part`` cells.  ``--arch`` may be given more than
once.

``--mesh {single,multi,both}`` counts each cell on
``launch.mesh.make_production_mesh(..., device="meta")``, the (16, 16)
and (2, 16, 16) meshes of 256 and 512 positions, into
``<arch>__<shape>[+opt]__<mesh>.json`` as the reference names its
records.  Such a record holds ``n_devices`` and one device's figures:
the first position's (the busiest: it holds its replica's dense work)
``flops``, ``bytes``, ``peak_bytes``, ``arg_bytes`` and
``collective_bytes`` by kind, its blocks of the parameters, the
optimizer state and the inputs under the cell's rules
(``param_bytes``, ``opt_state_bytes``, ``input_bytes``), the sums over
the mesh, and whether a device's peak fits one card.  The recsys family
runs data-parallel there (``launch.train.data_parallel_step``); the LM
family runs its per-position plan (``models.transformer.parallel``),
with an LM serving cell's ``cache_bytes`` (its block of the cache); a
PNA cell fails with the ROADMAP item its data axis waits for, and is
never counted as one device.  Prints one ``[ok]`` or ``[FAIL]`` line a
cell and the number of failures; exits 1 if any.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
H100_BYTES = 80 * 10**9


def card_memory(card_bytes: int | None = None) -> tuple[int, str]:
    """(bytes, what they are): ``card_bytes`` if given, else the first
    card's ``total_memory``, else 80 GB."""
    if card_bytes:
        return int(card_bytes), "given"
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"{props.name} total_memory"
    return H100_BYTES, "80 GB, an H100's, assumed: no card present"


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def _local(tree, specs, mesh) -> int:
    from repro_torch.sharding import rules
    return rules.local_bytes(tree, specs, mesh)


def _cache_bytes(cell, mesh) -> int:
    """A device's bytes of an LM serving cell's bf16 cache under its rule
    (the decode cell's argument, the prefill cell's output)."""
    from repro_torch.sharding import rules
    return math.prod(rules.local_shape(cell.cache, cell.specs["cache"], mesh)) * 2


def count_cell(arch: str, shape: str, card_bytes: int, card: str,
               opts: dict | None = None, mesh_name: str | None = None) -> dict:
    """The record of one cell (``ok`` False with the error where it cannot
    build or count); ``mesh_name`` ``single`` or ``multi``: one device of
    that production mesh, on ``meta``."""
    from repro_torch.launch import cost, steps
    from repro_torch.launch.mesh import make_production_mesh

    rec = {"arch": arch, "shape": shape, "device": "meta", "card_bytes": card_bytes,
           "card": card, "opts": sorted(opts or ())}
    mesh = None
    if mesh_name is not None:
        mesh = make_production_mesh(multi_pod=mesh_name == "multi", device="meta")
        rec.update({"mesh": mesh_name, "mesh_shape": mesh.shape, "n_devices": mesh.size})
    t0 = time.perf_counter()
    try:
        cell = steps.build(arch, shape, device="meta", opts=opts, mesh=mesh)
        params, *rest = cell.args
        state = rest.pop(0) if cell.kind in ("train", "graph") else None
        if mesh is None:
            work = cost.analyze(cell.fn, *cell.args)
            sizes = {"param_bytes": _tree_bytes(params), "opt_state_bytes": _tree_bytes(state),
                     "input_bytes": _tree_bytes(rest)}
        else:
            specs = cell.arg_specs()
            work = cost.analyze(cell.fn, *cell.args, mesh=mesh, specs=specs)
            sizes = {"param_bytes": _local(params, specs[0], mesh),
                     "opt_state_bytes": 0 if state is None else _local(state, specs[1], mesh),
                     "input_bytes": sum(_local(a, sp, mesh) for a, sp in
                                        zip(cell.args, specs) if a is not params
                                        and a is not state and sp is not cell.specs.get("cache"))}
            if "cache" in cell.specs:
                sizes["cache_bytes"] = _cache_bytes(cell, mesh)
        rec.update({
            "ok": True, "kind": cell.kind, "notes": list(cell.notes), **sizes,
            "flops": work["flops"], "bytes": work["bytes"], "peak_bytes": work["peak_bytes"],
            "kernels": work["kernels"], "collective_bytes": work["collective_bytes"],
            "count_seconds": time.perf_counter() - t0,
            "fits_one_card": work["peak_bytes"] <= card_bytes,
        })
        if mesh is not None:
            rec.update({"arg_bytes": work["arg_bytes"], "sum": work["sum"],
                        "positions_counted": work["positions_counted"]})
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:],
                    "count_seconds": time.perf_counter() - t0})
    return rec


def run_cell(arch: str, shape: str, *, force: bool = False, opts: dict | None = None,
             out: Path = RESULTS_DIR, card_bytes: int | None = None,
             mesh_name: str | None = None) -> dict:
    """The cell's record: read from ``out`` where a run wrote it, else
    counted and written there."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    tag = "".join(f"+{n}" for n in sorted(opts or ()))
    path = out / f"{arch}__{shape}{tag}{'' if mesh_name is None else '__' + mesh_name}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    rec = count_cell(arch, shape, *card_memory(card_bytes), opts=opts, mesh_name=mesh_name)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(rec, indent=1))
    tmp.replace(path)
    return rec


def collective_total(rec: dict) -> int:
    """Bytes of every collective kind of a mesh record (0 without one)."""
    return sum(row["total_bytes"] for row in (rec.get("collective_bytes") or {}).values())


def line(rec: dict) -> str:
    """The one line a record prints."""
    mesh = f" {rec['mesh']:6s}" if rec.get("mesh") else ""
    head = f"[{'ok' if rec.get('ok') else 'FAIL'}] {rec['arch']:22s} {rec['shape']:15s}{mesh}"
    if not rec.get("ok"):
        return f"{head} {rec['error'][:160]}"
    coll = (f"coll={collective_total(rec) / 2**20:.1f}MiB " if rec.get("mesh") else "")
    return (f"{head} flops={rec['flops']:.3e} bytes={rec['bytes']:.3e} "
            f"peak={rec['peak_bytes'] / 2**30:.2f}GiB {coll}"
            f"params={rec['param_bytes'] / 2**30:.2f}GiB "
            f"state={rec['opt_state_bytes'] / 2**30:.2f}GiB "
            f"fits={'yes' if rec['fits_one_card'] else 'no'} ({rec['count_seconds']:.1f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="an architecture to count (repeatable; default every one)")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi", "both"],
                    help="count a device of the production meshes, on meta")
    ap.add_argument("--force", action="store_true", help="count again, ignoring records")
    ap.add_argument("--opt", action="append", default=[],
                    help="a named option of launch.steps (records tagged +opt)")
    ap.add_argument("--out", default=str(RESULTS_DIR), help="the records' directory")
    ap.add_argument("--card-bytes", type=int, default=None,
                    help="the card memory a cell must fit (default: the card's, else 80 GB)")
    args = ap.parse_args(argv)

    from repro_torch.launch import steps

    cells = [(a, s) for a, s, _ in steps.all_cells()
             if (args.arch is None or a in args.arch) and (args.shape is None or s == args.shape)]
    meshes = {None: [None], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    opts = {name: True for name in args.opt} or None
    n_fail = 0
    for mesh_name in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, force=args.force, opts=opts, out=Path(args.out),
                           card_bytes=args.card_bytes, mesh_name=mesh_name)
            n_fail += not rec.get("ok")
            print(line(rec), flush=True)
    print(f"\ndone; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
