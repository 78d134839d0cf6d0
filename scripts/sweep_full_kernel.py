"""Kernel 1's design constants swept on one CUDA card.

    python3 scripts/sweep_full_kernel.py [--variants NAME,NAME]

Each variant is ``csrc/dplr_corpus_score.cu`` with some of its full-mode
constants replaced (``kFullThreads``: scoring threads a block,
``kFullSlots``: slots a thread scores at once, ``kFullStages``: the ring's
depth, ``kFullBlocks``: blocks an SM, which sets the launch bound and the
shared memory a block), built with nvcc into ``build/sweep_full/<name>/``
(all variants at once), and timed through its C entry point at
chip_smoke's timing rows of kernel 1: n = 2^20 slots, 1,000,000 live,
rho = 3, k = 16, Bq = 16 and 1, f32 and bf16 slabs, each at the variant's
default run (its threads times its slots).  ``device`` is the mean time a
call of 20 back-to-back calls queued behind a device-side sleep (CUDA
events), so no host time is in it.  Every variant's output is checked
bitwise against the first variant's (the committed constants).  Beside
them, ``torch.sum`` over the same slab's Q_I: the read rate of a library
reduction, a yardstick for the bytes.  ``DIAGNOSTICS`` take one part of
the work out of the committed kernel, to see where its time goes.

Prints the card, one JSON line a variant (the registers of its G = 16
and G = 1 instantiations, its four times) and the yardsticks (with a copy
of a (16, n) f32 tensor, whose bytes are half writes).  ``--clock S``
adds the SM clock and power draw nvidia-smi reads while each variant's
bf16 Bq = 16 call runs back to back for S seconds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# name -> constants replaced; the first is the committed file as it is
VARIANTS = {
    "committed": {},
    "1-slot": {"kFullSlots": 1},
    "1-slot-4-blocks": {"kFullSlots": 1, "kFullBlocks": 4},
    "1-slot-8-warps": {"kFullSlots": 1, "kFullThreads": 256},
    "1-slot-4-stages": {"kFullSlots": 1, "kFullStages": 4},
    "2-warps-4-blocks": {"kFullThreads": 64, "kFullBlocks": 4},
    "3-slots-2-warps": {"kFullSlots": 3, "kFullThreads": 64},
    "4-slots-2-warps": {"kFullSlots": 4, "kFullThreads": 64},
    "4-slots-2-warps-3-blocks": {"kFullSlots": 4, "kFullThreads": 64, "kFullBlocks": 3},
    "4-slots-4-warps-1-block": {"kFullSlots": 4, "kFullBlocks": 1},
    "3-blocks": {"kFullBlocks": 3},
    "3-blocks-2-warps-6-blocks": {"kFullThreads": 64, "kFullBlocks": 6},
}
# diagnostics: the committed constants with one part of the work taken out
# (their outputs are not scores, so they are not checked): no Q_I copies
# (the scorer reads whatever the stages hold), no stores of the scores, no
# scoring (loads and stores alone)
DIAGNOSTICS = {
    "no-copies": [("hopper::mbar_expect_tx(bar, boxes * box_bytes);",
                   "hopper::mbar_expect_tx(bar, 0);"),
                  ("if (live[b])\n              hopper::tma_load_2d",
                   "if (false)\n              hopper::tma_load_2d")],
    "no-stores": [("if (in[h]) __stcs(", "if (in[h] && sc[h][j] == 1234.5f) __stcs(")],
    "no-scoring": [("if (__any_sync(0xffffffffu, any)) {", "if (false) {")],
}


def variant_source(name: str) -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/dplr_corpus_score.cu").read_text()
    for old, new in DIAGNOSTICS.get(name, ()):
        if src.count(old) != 1:
            raise SystemExit(f"sweep_full_kernel: {name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    for name, value in VARIANTS.get(name, {}).items():
        src, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                            src)
        if hits != 1:
            raise SystemExit(f"sweep_full_kernel: no constant {name} in the source")
    return src


def build(names: list) -> dict:
    """Every variant's library, compiled at once; returns name -> (library
    path, ptxas log)."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    jobs = {}
    for name in names:
        out = ROOT / "build" / "sweep_full" / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, out)
        (out / "dplr_corpus_score.cu").write_text(variant_source(name))
        lib = out / "libfull.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
             str(out / "dplr_corpus_score.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        built[name] = (lib, log)
    if failed:
        raise SystemExit("sweep_full_kernel: variants did not build:\n" + "\n".join(failed))
    return built


def registers(log: str) -> dict:
    """Registers and spill-store bytes of the G = 16 and G = 1 full-mode
    kernels, by (G, slab type, accumulation mode)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"corpus_score_fullILi(\d+)E(f|13__nv_bfloat16)Li(\d)E", m.group(1))
            cur = (f"G{t.group(1)} {'f32' if t.group(2) == 'f' else 'bf16'} acc{t.group(3)}"
                   if t and t.group(1) in ("1", "16") else None)
        elif cur and (m := re.search(r"(\d+) bytes spill stores", ln)):
            out.setdefault(cur, {})["spill_stores"] = int(m.group(1))
        elif cur and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def queued_ms(fn, repeats=20) -> float:
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
        queued = not start.query()
        stop.record()
        stop.synchronize()
        if queued:
            return start.elapsed_time(stop) / repeats
        cycles *= 4


def sampled_clocks(fn, seconds: float) -> dict:
    """The median SM clock (MHz) and power draw (W) that nvidia-smi reads
    every 50 ms while ``fn`` runs back to back for ``seconds``."""
    import statistics
    import time

    import torch
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    rows = rows[len(rows) // 4:]            # past the ramp
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows), "samples": len(rows)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clock", type=float, default=0.0,
                    help="seconds to run each variant's bf16 Bq = 16 call back to back "
                         "while nvidia-smi samples the SM clock and the power draw")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS or DIAGNOSTICS (the first, "
                         "a variant, is the reference)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("sweep_full_kernel: this sweep needs a CUDA card")
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = build(names)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    n, live, rho, k = 1 << 20, 1_000_000, 3, 16
    Q = torch.randn((n, rho, k), generator=gen, device=dev) * 0.5
    a = torch.randn((n,), generator=gen, device=dev)
    e = torch.rand((rho,), generator=gen, device=dev) + 0.5
    P = torch.randn((16, rho, k), generator=gen, device=dev) * 0.5
    aC = torch.randn((16,), generator=gen, device=dev)
    valid = torch.arange(n, device=dev) < live
    slabs = {"f32": (Q, a, 0), "bf16": (Q.to(torch.bfloat16), a.to(torch.bfloat16), 1)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    want, clocks = {}, {}
    for name in names:
        lib = ctypes.CDLL(str(built[name][0]))
        fn = lib.dplr_corpus_score_full
        fn.argtypes = [P_] * 6 + [L_, I_, I_, I_, I_, I_, I_, L_, P_, P_, I_]
        fn.restype = I_
        consts = {"kFullThreads": 128, "kFullSlots": 2, **VARIANTS.get(name, {})}
        run = consts["kFullThreads"] * consts["kFullSlots"]
        times = {}
        for label, (q, a_, code) in slabs.items():
            for Bq in (16, 1):
                out = torch.empty((Bq, n), device=dev)

                def call():
                    status = fn(q.data_ptr(), a_.data_ptr(), valid.data_ptr(), e.data_ptr(),
                                P.data_ptr(), aC.data_ptr(), n, Bq, rho, k, code, 0,
                                min(Bq, 16), run, out.data_ptr(), stream, 0)
                    if status:
                        raise RuntimeError(f"{name}: CUDA error {status}")
                ms = queued_ms(call)
                key = f"{label} Bq={Bq}"
                if args.clock and key == "bf16 Bq=16":
                    clocks[name] = sampled_clocks(call, args.clock)
                bits = out.view(torch.int32).clone()
                want.setdefault(key, bits)
                times[key] = {"device_ms": ms, "bitwise": bool(torch.equal(bits, want[key]))}
        print(json.dumps({"variant": name, "constants": VARIANTS.get(name, DIAGNOSTICS.get(name)),
                          "registers": registers(built[name][1]), "times": times,
                          "clock": clocks.get(name)}), flush=True)
    for label, (q, _, _) in slabs.items():
        ms = queued_ms(lambda: q.sum())
        print(json.dumps({"yardstick": f"torch.sum over Q_I {label}", "device_ms": ms,
                          "TB_per_s": q.numel() * q.element_size() / ms / 1e9}), flush=True)
    # a copy of (16, n) f32 (Bq = 16's output) from the slab: reads and writes
    out = torch.empty((16, n), device=dev)
    ms = queued_ms(lambda: out.copy_(Q.view(-1)[:16 * n].view(16, n)))
    print(json.dumps({"yardstick": "copy of 16 x 2^20 f32", "device_ms": ms,
                      "TB_per_s": 2 * out.numel() * 4 / ms / 1e9}), flush=True)


if __name__ == "__main__":
    main()
