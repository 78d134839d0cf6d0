"""Time the embedding bag's backward (kernel 5') on one CUDA card, at
``chip_smoke.py``'s ``bag_backward_timing`` shape: 4,096 x 82 one-hot
skewed slots on the full 33,040,384-row arena, k = 16.

    python3 scripts/profile_bag_backward.py
    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/profile_bag_backward.py --other build/parent

Each checkout runs in a process of its own that builds its kernels (into its
own ``build/``) and times, through its ``ops``, the whole call and, where the
checkout has them, the slots' radix sort alone and the writer alone (on one
sort's result); and the yardsticks the port never calls: a stable
``torch.sort`` of the ids, ``torch.zeros`` of the table, and zeros +
``index_add_``.  Three numbers a call, in ms, as ``scripts/ab_corpus.py``
takes them: ``b2b`` (back-to-back calls between CUDA events), ``device``
(the calls queued behind a device-side sleep) and ``host`` (issuing one);
and the device time of each CUDA kernel of the call, from
``torch.profiler``.  With ``--other``, the rounds run the other checkout,
this one, this one, the other.  Prints one JSON line a process.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

from ab_corpus import _device_ms, _host_ms, _queued_ms  # noqa: E402


def _kernel_ms(fn, reps=5) -> dict:
    """{CUDA kernel: device ms a call} over ``reps`` calls, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0
        if t and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+)(?:<[^<>()]*>)?\(", evt.key)   # name<args>( -> name
            name = m.group(1) if m else evt.key[:60]
            out[name] = round(out.get(name, 0.0) + t / 1e3 / reps, 4)
    return out


def measure(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    sys.path.insert(0, str(checkout))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import embedding_bag as bag_lib
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = cs.FULL.make_config()
    lay, k, B = cfg.layout, cfg.embed_dim, cs.FULL.train_batch
    table = torch.randn((cs.padded_rows(lay.total_vocab), k), generator=gen, device=dev)
    rows = table.shape[0]
    ids, w, bags = cs.bag_case(lay, None, B, gen, skew=True)
    g = torch.randn((B, bags.n_bags, k), generator=gen, device=dev)
    src = (g.index_select(1, bags.segments) * w[..., None]).reshape(-1, k)
    flat = ids.reshape(-1)
    calls = {"backward": lambda: ops.embedding_bag_backward(g, table, ids, w, bags),
             "torch.sort": lambda: torch.sort(flat, stable=True),
             "zeros": lambda: torch.zeros_like(table),
             "zeros + index_add_": lambda: torch.zeros_like(table).index_add_(0, flat.long(), src)}
    if hasattr(ops, "bag_rows_sort"):
        keys, perm, scratch = bag_lib.launch_sort(flat, rows)
        out = torch.empty_like(table)
        calls["sort"] = lambda: ops.bag_rows_sort(ids, rows)
        calls["writer"] = lambda: bag_lib.launch_writer(g, keys, perm, w, bags, scratch, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"checkout": str(checkout), "card": smi, "shape": [B, ids.shape[1]], "rows": rows}
    for name, fn in calls.items():
        result[name] = {"b2b": round(_device_ms(fn), 4), "device": round(_queued_ms(fn), 4),
                        "host": round(_host_ms(fn), 4), "kernels": _kernel_ms(fn)}
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, help="another checkout, measured in turns")
    parser.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())), flush=True)
        return
    order = [ROOT] if args.other is None else [args.other, ROOT, ROOT, args.other]
    for checkout in order:
        subprocess.run([sys.executable, __file__, "--measure", str(checkout)], check=True)


if __name__ == "__main__":
    main()
