"""A/B of the corpus kernels (1, 2 and 4) at their default geometry, or of
the slab's row build, between this checkout and another, on one CUDA card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/ab_corpus.py --other build/parent [--rounds 1] [--set rows]

Each round runs the other checkout, this one, this one, the other, each in
a process of its own that builds that checkout's corpus kernels (into its
own ``build/``) and times, through its ``repro_torch.kernels.ops`` with
nothing tuned, the shapes of ``chip_smoke.py``'s timing rows: n = 2^20
slots, 1,000,000 live, rho = 3, k = 16, the top-K at K = 16 and Bq = 16
and 1, the full scores (kernel 1) at Bq = 16 and 1 (and both with
``acc_dtype='bfloat16'``), f32 and bf16 slabs; and the packed wave, 16
slabs of 65,536 slots (62,500 live) at Bq = 4.  Three numbers a call, in
ms:

  * ``b2b``: chip_smoke's ``device_ms``, the median of 5 batches of 10
    back-to-back calls between CUDA events; when the host takes longer to
    issue a call than the card to run it, this is host time;
  * ``device``: the same calls queued behind a device-side sleep, so the
    card runs them back to back whatever the host's pace: device time;
  * ``host``: the host's time to issue one call, the mean over 20.

Each full-score call also gives the sha256 of its (Bq, n) output's bytes
(the inputs come from one seed on the card, so both checkouts score the
same inputs), and the last line says, per call, whether every process of
both checkouts gave the same digest: whether the two kernels agree bit for
bit.

``--set rows`` times instead, through the checkout's ``CorpusState`` at
the serve config (``configs.dplr_fwfm.make_config()``: 82 fields, k = 16,
rho = 3), with random weights from seed 0, float32 and bf16 (cast as
``serve --bf16`` casts them): the slab build (``refresh``) of 1,000,000
items in 2^20 slots, and churn writes (``update_items``) of 1, 16, 256 and
4,096 live slots.  One number a call, ``host``: the median host-clock ms
of the call followed by a synchronize (3 builds after one warm-up, 20
writes after two).

Prints one JSON line a process, then the mean of each number over each
checkout's processes, and last the digests' agreement.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _device_ms(fn, batches=5, per_batch=10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_batch)
    return sorted(times)[len(times) // 2]


def _queued_ms(fn, repeats=20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000 * repeats
    while True:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(repeats):
            fn()
        queued = not start.query()          # the sleep outlasted the host's queueing
        stop.record()
        stop.synchronize()
        if queued:
            return start.elapsed_time(stop) / repeats
        cycles *= 4


def _host_ms(fn, reps=20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def _synced_ms(fn, reps: int, warm: int) -> float:
    import numpy as np
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


def measure_rows(checkout: Path) -> dict:
    """The slab build's and churn writes' host times in ``checkout``'s
    code, built from its own sources."""
    sys.path.insert(0, str(checkout / "src"))
    import torch
    from repro_torch.configs import dplr_fwfm
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.launch.serve import to_serving_dtype
    from repro_torch.models.recsys import fwfm
    from repro_torch.serving import CorpusState

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dplr_fwfm.make_config()
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=0)
    corpus = data.ranking_query(1_000_000, 0)
    writes = {n: data.ranking_query(n, 1 + n)["item_ids"][0] for n in (1, 16, 256, 4096)}
    params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    out = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        p = to_serving_dtype(params, bf16)
        engine = CorpusState(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                             capacity=1 << 20, device=dev)
        out[f"{name} slab build 1000000"] = {"host": _synced_ms(lambda: engine.refresh(p), 3, 1)}
        live = engine.valid_slots
        for n, ids in writes.items():
            slots = live[:: len(live) // n][:n]
            out[f"{name} churn write {n}"] = {
                "host": _synced_ms(lambda: engine.update_items(slots, ids), 20, 2)}
        del engine
        torch.cuda.empty_cache()
    return out


def measure(checkout: Path) -> dict:
    """The calls' three times in ``checkout``'s code, built from its own
    sources."""
    sys.path.insert(0, str(checkout / "src"))
    import torch
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def slab(n, live, Bq):
        Q = torch.randn((n, 3, 16), generator=gen, device=dev) * 0.5
        a = torch.randn((n,), generator=gen, device=dev)
        e = torch.rand((3,), generator=gen, device=dev) + 0.5
        P = torch.randn((Bq, 3, 16), generator=gen, device=dev) * 0.5
        aC = torch.randn((Bq,), generator=gen, device=dev)
        return Q, a, e, P, aC, torch.arange(n, device=dev) < live

    Q, a, e, P, aC, valid = slab(1 << 20, 1_000_000, 16)
    parts = [slab(65_536, 62_500, 4) for _ in range(16)]
    multi = (tuple(p[0] for p in parts), tuple(p[1] for p in parts),
             tuple(p[5] for p in parts), *(torch.stack([p[j] for p in parts]) for j in (2, 3, 4)))
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, a_ = Q.to(dtype), a.to(dtype)
        m = (tuple(x.to(dtype) for x in multi[0]), tuple(x.to(dtype) for x in multi[1]),
             *multi[2:])
        calls = {
            f"{name} topk Bq=16": lambda: ops.dplr_corpus_score(q, a_, e, P, aC, valid, topk=16),
            f"{name} topk Bq=1": lambda: ops.dplr_corpus_score(q, a_, e, P[:1], aC[:1], valid,
                                                               topk=16),
            f"{name} full Bq=16": lambda: ops.dplr_corpus_score(q, a_, e, P, aC, valid),
            f"{name} full Bq=1": lambda: ops.dplr_corpus_score(q, a_, e, P[:1], aC[:1], valid),
            f"{name} full Bq=16 acc bf16": lambda: ops.dplr_corpus_score(
                q, a_, e, P, aC, valid, acc_dtype="bfloat16"),
            f"{name} full Bq=1 acc bf16": lambda: ops.dplr_corpus_score(
                q, a_, e, P[:1], aC[:1], valid, acc_dtype="bfloat16"),
            f"{name} multi 16 x Bq=4": lambda: ops.dplr_corpus_score_multi(*m, topk=16),
        }
        for label, fn in calls.items():
            out[label] = {"b2b": _device_ms(fn), "device": _queued_ms(fn), "host": _host_ms(fn)}
            if " full " in label:
                got = fn().contiguous().view(torch.int32).cpu().numpy()
                out[label]["sha256"] = hashlib.sha256(got.tobytes()).hexdigest()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the checkout to compare this one with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--set", choices=["kernels", "rows"], default="kernels",
                    help="kernels: the corpus kernels' three times; rows: the slab build's "
                         "and churn writes' host times")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        fn = measure_rows if args.set == "rows" else measure
        print(json.dumps(fn(args.measure)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_corpus: this comparison needs a CUDA card")
    if args.other is None or not (args.other / "src" / "repro_torch").is_dir():
        sys.exit("ab_corpus: --other must name a checkout with src/repro_torch")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sides = {"other": args.other.resolve(), "this": ROOT}
    runs: dict[str, list] = {"other": [], "this": []}
    for r in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            res = subprocess.run([sys.executable, __file__, "--set", args.set,
                                  "--measure", str(sides[side])],
                                 capture_output=True, text=True, check=True, timeout=900,
                                 cwd=sides[side])
            got = json.loads(res.stdout.strip().splitlines()[-1])
            runs[side].append(got)
            print(json.dumps({"round": r, "side": side, "times": got}), flush=True)
    mean = {side: {label: {k: sum(run[label][k] for run in got) / len(got)
                           for k in got[0][label] if k != "sha256"}
                   for label in got[0]}
            for side, got in runs.items()}
    print(json.dumps({"mean": mean}), flush=True)
    digests = {label: {run[label]["sha256"] for got in runs.values() for run in got}
               for label in runs["this"][0] if "sha256" in runs["this"][0][label]}
    print(json.dumps({"bitwise": {label: len(d) == 1 for label, d in digests.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
