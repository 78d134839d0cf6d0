"""How far granite-moe-1b-a400m's decode logits move under last-bit
changes, on one CUDA card, at ``chip_smoke.py``'s lm-phase shapes: random
f32 weights from seed 0 (the reference's init scales: an expert stack at
1/sqrt(E)), bf16 compute, B = 2 prompts of 32,256 tokens into 32,768
slots, 16 decode steps of random tokens.

    python3 scripts/moe_decode_sensitivity.py [--prompt 32256] [--steps 16]

Each case holds the decode steps' logits against one pass over the same
positions (``chip_smoke.plain_extend`` under the steps' routes), as the
lm phase does, and prints one JSON line: the largest ratio of |diff| to
``3e-3 + 3e-2 |x|``, and the largest relative difference of each layer's
MoE input between the two.  Cases:

  * ``slots``: the one pass's keys span the cache's 32,768 slots, as
    decode's do (the lm phase's check);
  * ``written``: they span the 32,272 written positions only, so its
    attention products have another length than decode's;
  * ``ulp``: the ``slots`` one pass with every cache entry one bf16 ulp
    away from zero, against the unchanged one pass: the model's own
    sensitivity;
  * ``fan_in``: ``slots`` and ``ulp`` with the experts rescaled to
    1/sqrt(fan in), the dense layers' scale;
  * ``f32``: ``slots`` in f32 compute.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import granite_moe_1b_a400m  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.models.transformer import moe  # noqa: E402


@contextlib.contextmanager
def moe_inputs(store: list):
    """Inside, each ``moe.moe_ffn`` call's input (T, d) in f32 is kept."""
    real = moe.moe_ffn

    def keep(x, *args, **kw):
        store.append(x.detach().float().reshape(-1, x.shape[-1]).clone())
        return real(x, *args, **kw)

    moe.moe_ffn = keep
    try:
        yield
    finally:
        moe.moe_ffn = real


def one_pass(params, cfg, fed, cache, S, routes):
    """Logits of ``plain_extend`` under ``routes`` and its MoE inputs."""
    xs = []
    with moe_inputs(xs), cs.routed(force=routes):
        h, cp = cs.plain_extend(params, cfg, torch.cat(fed, 1), cache, S)
    return tm._logits(cp, cfg, h)[..., :cfg.vocab].float(), xs


def ratio(got, want) -> float:
    return float(((got - want).abs() / (3e-3 + 3e-2 * want.abs())).max())


def case(name, params, cfg, B, S, S_max, n, dev, ulp=False) -> dict:
    L, V = cfg.n_layers, cfg.vocab
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, V, (B, S + n), generator=gen, device=dev)
    _, cache = tm.prefill(params, cfg, toks[:, :S], S_max, device=dev)
    fed = [toks[:, S + i:S + i + 1] for i in range(n)]
    dec_x = []
    with moe_inputs(dec_x), cs.routed() as rec:
        got = torch.stack([tm.decode_step(params, cfg, t, cache, S + i, device=dev)[0][:, 0, :V]
                           for i, t in enumerate(fed)], 1).float()
    routes = [torch.cat(rec.own[l::L]) for l in range(L)]
    dec = [torch.cat(dec_x[l::L]) for l in range(L)]        # position-major, as the pass
    out = {"case": name}
    for keys, kv in (("slots", cache), ("written", cache[:, :, :, :S + n])):
        want, xs = one_pass(params, cfg, fed, kv, S, routes)
        out[keys] = dict(ratio=ratio(got, want), max_abs_diff=float((got - want).abs().max()),
                         moe_input_rel_diff=[float((a - b).abs().max() / b.abs().max())
                                             for a, b in zip(dec, xs)])
        if keys == "slots":
            base = want
    if ulp:
        bumped = (cache.view(torch.int16) + 1).view(cache.dtype)
        want, _ = one_pass(params, cfg, fed, bumped, S, routes)
        out["ulp"] = dict(ratio=ratio(want, base), max_abs_diff=float((want - base).abs().max()))
    out["max_abs_logit"] = float(base.abs().max())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=32_256)
    ap.add_argument("--cache", type=int, default=32_768)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("moe_decode_sensitivity: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = granite_moe_1b_a400m.make_config()
    shape = (args.batch, args.prompt, args.cache, args.steps, dev)
    params = tm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    for line in (case("reference init", params, cfg, *shape, ulp=True),
                 case("f32", params, dataclasses.replace(cfg, compute_dtype=torch.float32),
                      *shape)):
        print(json.dumps(line), flush=True)
    for name in ("w_gate", "w_in"):
        params["layers"][name] *= (cfg.n_experts / cfg.d_model) ** 0.5
    params["layers"]["w_out"] *= (cfg.n_experts / cfg.d_ff) ** 0.5
    print(json.dumps(case("fan_in", params, cfg, *shape, ulp=True)), flush=True)


if __name__ == "__main__":
    main()
