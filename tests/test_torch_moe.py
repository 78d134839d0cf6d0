"""The port's mixture-of-experts LMs (``repro_torch.models.transformer.moe``,
the MoE layers of ``model``, ``configs/{granite_moe_1b_a400m,mixtral_8x7b}``)
against the JAX package's, on the CPU.

Both packages get the same numpy inputs and weights (the JAX ``init``,
through ``interop``).  Routing is discrete: a last-bit difference in the
router's input can flip a choice at a near tie, and through capacity a flip
moves other tokens' slots.  So every comparison of two paths first compares
their routes (experts, slots, keep), token by token and layer by layer:
the JAX routes are recorded inside its traced code (``jax.debug.callback``
on the top-k it takes), the port's by a wrapper of ``moe.moe_ffn``.
Bounds:

  * routing (``router_probs``, ``_positions_in_expert``) on the same
    logits: experts, slots and keep bitwise, planted ties included; the
    gates within 1e-6 (one softmax in f32, its exp rounded per library);
  * ``moe_ffn_group`` / ``moe_ffn``, every implementation, f32: 1e-5;
  * bf16: the port's largest error from the JAX f32 output at most twice
    the JAX bf16 output's (both round each product to bf16, in other
    orders), with the routes of all four runs equal;
  * the models at ``make_smoke()``, f32 compute: routes equal, then
    ``forward``, ``prefill`` and 6 ``decode_step``s within 2e-4 (the dense
    tests' bound), ``lm_loss`` within ``1e-5 max(1, |loss|)`` and each
    gradient within ``1e-4`` of its largest ``|g|`` (the dense training
    tests' bounds);
  * bf16 compute: each package against its own f32 run, the port's error
    at most 2x the JAX package's, over the outputs that no differing route
    reaches (a differing route at a position reaches every later position
    of its row, and a decode step every later step); the differing routes
    are counted and printed.
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.models.transformer import moe as jmoe  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.models.transformer import moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
MOE_ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b")
# (impl, fused_combine): the three implementations of the reference
IMPLS = [("einsum", False), ("scatter", False), ("einsum", True)]


def _f32(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _group_inputs(seed, G, g, d, E, f):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    x = n(G, g, d)
    r = n(d, E) / np.float32(np.sqrt(d))
    wg, wi = n(E, d, f) / np.float32(np.sqrt(d)), n(E, d, f) / np.float32(np.sqrt(d))
    wo = n(E, f, d) / np.float32(np.sqrt(f))
    return x, r, wg, wi, wo


# the reference's groups, as its moe_ffn takes them (vmap)
_jgroups = jax.jit(lambda x, r, wg, wi, wo, cfg: jax.vmap(
    lambda xs: jmoe.moe_ffn_group(xs, r, wg, wi, wo, cfg))(x), static_argnums=5)

_jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=5)


def _jax_group(args, jcfg, dtype):
    return _f32(_jgroups(*(jnp.asarray(a).astype(dtype) for a in args), jcfg))


def _torch_group(args, cfg, dtype):
    return _f32(moe.moe_ffn_group(*(torch.from_numpy(a).to(dtype) for a in args), cfg))


# -- routing ------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,cf,g", [(8, 2, 1.25, 16), (32, 8, 1.25, 512), (8, 2, 1.25, 1),
                                      (4, 1, 0.25, 16), (8, 2, 1.25, 2), (32, 8, 1.25, 2)])
def test_capacity_matches_jax(E, k, cf, g):
    jcfg, cfg = _cfgs(n_experts=E, top_k=k, capacity_factor=cf, group_size=g)
    assert moe.capacity(cfg) == jmoe.capacity(jcfg)
    if (E, g) == (32, 2):           # granite's decode step at B = 2: one slot an expert
        assert moe.capacity(cfg) == 1


@pytest.mark.parametrize("mode", ["topk_softmax", "softmax_topk"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
def test_router_and_slots_bitwise(mode, dtype, ties):
    """Experts, slots and keep bitwise the reference's on the same logits;
    with ``ties`` most logits tie (a few values on a coarse grid), and both
    put equal logits lowest expert first."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    G, g, E, k = 3, 32, 8, 3
    if ties:
        logits = rng.integers(-2, 3, (G, g, E)).astype(np.float32) * np.float32(0.5)
    else:
        logits = rng.standard_normal((G, g, E), dtype=np.float32)
    jcfg, cfg = _cfgs(n_experts=E, top_k=k, capacity_factor=0.75, group_size=g,
                      router_mode=mode)
    lg = torch.from_numpy(logits).to(tdt)
    gates, experts = moe.router_probs(lg, cfg)
    flat_e, slot, flat_gate, keep = moe._positions_in_expert(experts, gates, cfg)
    for i in range(G):
        jg, je = jmoe.router_probs(jnp.asarray(logits[i]).astype(jdt), jcfg)
        np.testing.assert_array_equal(experts[i].numpy(), np.asarray(je))
        np.testing.assert_allclose(_f32(gates[i]), _f32(jg), rtol=1e-6, atol=0)
        want = jmoe._positions_in_expert(je, jg, jcfg)
        for got, w in ((flat_e, want[0]), (slot, want[1]), (keep, want[3])):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(w))
    if ties:                        # the planted ties are there and were taken in order
        top = torch.sort(lg, dim=-1, descending=True).values
        assert int((top[..., k - 1] == top[..., k]).sum()) > G * g // 4
    assert not bool(keep.all()) and bool(keep.any())      # capacity drops some
    np.testing.assert_array_equal(moe.slots(experts.reshape(-1, k), cfg)[0].numpy(),
                                  slot.reshape(-1, k).numpy())


def test_load_balancing_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 16, 8), dtype=np.float32)
    jcfg, cfg = _cfgs(n_experts=8, top_k=2)
    _, je = jmoe.router_probs(jnp.asarray(logits), jcfg)
    want = float(jmoe.load_balancing_loss(jnp.asarray(logits), je, jcfg))
    lg = torch.from_numpy(logits)
    got = float(moe.load_balancing_loss(lg, moe.router_probs(lg, cfg)[1], cfg))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


# -- the FFN ------------------------------------------------------------------------

@pytest.mark.parametrize("impl,fused", IMPLS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_group_matches_jax(impl, fused, cf):
    """Per group, f32 within 1e-5; bf16: the port's error from the JAX f32
    output at most twice the JAX bf16 output's, under equal routes."""
    args = _group_inputs(0, 3, 16, 32, 8, 24)
    jcfg, cfg = _cfgs(n_experts=8, top_k=2, capacity_factor=cf, group_size=16, impl=impl,
                      fused_combine=fused)
    want = _jax_group(args, jcfg, jnp.float32)
    np.testing.assert_allclose(_torch_group(args, cfg, torch.float32), want, rtol=1e-5,
                               atol=1e-5)
    x16 = torch.from_numpy(args[0]).bfloat16()
    r16 = torch.from_numpy(args[1]).bfloat16()
    jroutes = jmoe.router_probs(jnp.asarray(args[0]).astype(jnp.bfloat16)
                                @ jnp.asarray(args[1]).astype(jnp.bfloat16), jcfg)[1]
    np.testing.assert_array_equal(moe.route(x16, r16, cfg).numpy(),
                                  np.asarray(jroutes).reshape(-1, 2))
    err_j = np.abs(_jax_group(args, jcfg, jnp.bfloat16) - want).max()
    err_t = np.abs(_torch_group(args, cfg, torch.bfloat16) - want).max()
    assert 0 < err_t <= 2 * err_j, (err_t, err_j)


@pytest.mark.parametrize("impl,fused", IMPLS)
def test_moe_ffn_groups_the_tokens_as_jax(impl, fused):
    """(B, S, d) in groups of 16 (8 of them), and a B S below the group
    size (one group of B S), f32 within 1e-5."""
    x, *w = _group_inputs(1, 4, 32, 32, 8, 24)
    jcfg, cfg = _cfgs(n_experts=8, top_k=2, group_size=16, impl=impl, fused_combine=fused)
    for xs in (x, x[:2, :5]):
        want = np.asarray(_jmoe_ffn(jnp.asarray(xs), *map(jnp.asarray, w), jcfg))
        got = moe.moe_ffn(torch.from_numpy(xs), *map(torch.from_numpy, w), cfg)
        assert got.shape == xs.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_impls_agree_with_each_other():
    """einsum = scatter = fused combine (``tests/test_transformer.py:49``,
    ``tests/test_perf_variants.py:82``), on the port alone: 1e-5 in f32."""
    args = _group_inputs(2, 4, 16, 32, 8, 24)
    outs = [_torch_group(args, moe.MoEConfig(n_experts=8, top_k=2, capacity_factor=1.0,
                                             group_size=16, impl=impl, fused_combine=fused),
                         torch.float32) for impl, fused in IMPLS]
    for out in outs[1:]:
        np.testing.assert_allclose(out, outs[0], rtol=1e-5, atol=1e-5)


def test_capacity_drops_tokens():
    """``tests/test_transformer.py:61`` on the port: capacity 2 an expert
    for 16 tokens, so at least 12 output rows are 0; the rows equal JAX's."""
    jcfg, cfg = _cfgs(n_experts=2, top_k=1, capacity_factor=0.25, group_size=16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8), dtype=np.float32)
    router = rng.standard_normal((8, 2), dtype=np.float32)
    wg, wi = (rng.standard_normal((2, 8, 16), dtype=np.float32) for _ in range(2))
    wo = rng.standard_normal((2, 16, 8), dtype=np.float32)
    t = torch.from_numpy
    out = moe.moe_ffn_group(t(x)[None], t(router), t(wg), t(wi), t(wo), cfg)[0]
    assert bool(torch.isfinite(out).all())
    assert int((out.abs().sum(-1) == 0).sum()) >= 12
    want = jmoe.moe_ffn_group(jnp.asarray(x), jnp.asarray(router), jnp.asarray(wg),
                              jnp.asarray(wi), jnp.asarray(wo), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tokens_not_a_multiple_of_the_group_raise():
    _, cfg = _cfgs(n_experts=4, top_k=2, group_size=16)
    x, *w = _group_inputs(0, 1, 24, 8, 4, 8)
    with pytest.raises(ValueError, match="24 tokens do not split into MoE groups of 16"):
        moe.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, w), cfg)


# -- recording routes ---------------------------------------------------------------

@contextlib.contextmanager
def _recording():
    """Inside, each call of either package's ``moe_ffn`` (their models look
    it up at each call) appends ``(router_w, experts (T, k))`` to the JAX
    or the port's list.  The JAX experts come from the same top-k on the
    same logits as the call's own, inside its traced code; the port's call
    runs under the routes it records."""
    jrecords, records = [], []
    jreal, real = jmoe.moe_ffn, moe.moe_ffn

    def keep(r, e):
        jrecords.append((np.asarray(r), np.asarray(e)))

    def jax_recording(x, router_w, w_gate, w_in, w_out, cfg):
        flat = x.reshape(-1, x.shape[-1])
        gsz = min(cfg.group_size, flat.shape[0])
        gcfg = dataclasses.replace(cfg, group_size=gsz)
        experts = jax.vmap(lambda xs: jmoe.router_probs(xs @ router_w, gcfg)[1])(
            flat.reshape(-1, gsz, flat.shape[-1]))
        jax.debug.callback(keep, router_w, experts.reshape(-1, cfg.top_k))
        return jreal(x, router_w, w_gate, w_in, w_out, cfg)

    def recording(x, router_w, w_gate, w_in, w_out, cfg, experts=None):
        mine = moe.route(x, router_w, cfg)
        records.append((router_w.detach().float().numpy(), mine.numpy()))
        return real(x, router_w, w_gate, w_in, w_out, cfg, mine if experts is None else experts)

    jmoe.moe_ffn, moe.moe_ffn = jax_recording, recording
    try:
        yield jrecords, records
    finally:
        jmoe.moe_ffn, moe.moe_ffn = jreal, real


def _by_layer(records, routers):
    """[(layer, experts)] in call order, each call's layer found by its
    router weights (the compute dtype's rounding of ``routers[layer]``)."""
    out = []
    for r, e in records:
        hits = [i for i, w in enumerate(routers) if np.array_equal(_f32(r), w)]
        assert len(hits) == 1, hits
        out.append((hits[0], e))
    return out


def _route_keys(experts: np.ndarray, cfg) -> np.ndarray:
    """(T, 3k): each token's experts, slots and keep."""
    e = torch.from_numpy(np.asarray(experts).astype(np.int64))
    slot, keep = moe.slots(e, cfg.moe_cfg)
    return np.concatenate([e.numpy(), slot.numpy(), keep.numpy()], axis=1)


def _differ(a: list, b: list, cfg) -> list:
    """Per call, the (T,) mask of tokens whose routes differ."""
    assert [la for la, _ in a] == [lb for lb, _ in b]
    return [(_route_keys(ea, cfg) != _route_keys(eb, cfg)).any(1) for (_, ea), (_, eb) in
            zip(a, b)]


# -- the models ---------------------------------------------------------------------

def _configs(which: str, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(JREGISTRY[which].make_smoke(), compute_dtype=jdt),
            dataclasses.replace(REGISTRY[which].make_smoke(), compute_dtype=tdt))


def _weights(jcfg, seed=0):
    jparams = jtm.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, interop.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _routers(params, dtype):
    r = params["layers"]["router"]
    if hasattr(r, "detach"):
        return [_f32(r[i].to(dtype)) for i in range(r.shape[0])]
    return [_f32(jnp.asarray(r[i]).astype(dtype)) for i in range(r.shape[0])]


S_FWD, N_PROMPT, N_DECODE = 16, 8, 6      # B S = 32 and 16: whole groups of 16


def _run(pkg, cfg, params, toks, records):
    """forward logits on all S_FWD tokens, prefill (logits, cache) on the
    first N_PROMPT and N_DECODE decode steps after it; and the routes of
    each: [(layer, experts)] of forward, prefill, and of each step."""
    def take():
        got = list(records)
        records.clear()
        return got

    S = N_PROMPT + N_DECODE
    if pkg == "jax":        # fresh jits: a cached trace would keep another recorder
        t = jnp.asarray(toks)
        fwd = jax.block_until_ready(jax.jit(lambda p, x: jtm.forward(p, cfg, x))(params, t))
        r_fwd = take()
        pre = jax.block_until_ready(jax.jit(lambda p, x: jtm.prefill(p, cfg, x, S_FWD))(
            params, t[:, :N_PROMPT]))
        r_pre = take()
        decode = jax.jit(lambda p, x, c, i: jtm.decode_step(p, cfg, x, c, i))
        cache = pre[1]
        steps, r_steps = [], []
        for s in range(N_PROMPT, S):
            lg, cache = jax.block_until_ready(decode(params, t[:, s:s + 1], cache,
                                                     jnp.asarray(s)))
            steps.append(lg)
            r_steps.append(take())
    else:
        t = torch.from_numpy(toks)
        fwd = tm.forward(params, cfg, t, device="cpu")
        r_fwd = take()
        lg, cache = tm.prefill(params, cfg, t[:, :N_PROMPT], S_FWD, device="cpu")
        pre = (lg, cache.clone())
        r_pre = take()
        steps, r_steps = [], []
        for s in range(N_PROMPT, S):
            lg, cache = tm.decode_step(params, cfg, t[:, s:s + 1], cache, s, device="cpu")
            steps.append(lg)
            r_steps.append(take())
    V = cfg.vocab
    out = dict(forward=_f32(fwd)[..., :V], prefill=_f32(pre[0])[..., :V],
               decode=np.stack([_f32(x)[:, 0, :V] for x in steps], 1),
               prefill_cache=_f32(pre[1]), decode_cache=_f32(cache))
    return out, dict(forward=r_fwd, prefill=r_pre, decode=r_steps)


@functools.lru_cache(maxsize=None)
def _both(which, dtype):
    """Both packages' runs of ``_run`` on one set of weights and tokens,
    with their routes by layer; computed once a (model, dtype)."""
    jcfg, cfg = _configs(which, dtype)
    jparams, params = _weights(jcfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, S_FWD)).astype(np.int32)
    with _recording() as (jrec, trec):
        want, jr = _run("jax", jcfg, jparams, toks, jrec)
        got, tr = _run("torch", cfg, params, toks, trec)
    jrouters, routers = _routers(jparams, jcfg.compute_dtype), _routers(params,
                                                                       cfg.compute_dtype)
    assert all(np.array_equal(a, b) for a, b in zip(jrouters, routers))
    for name in ("forward", "prefill"):
        jr[name], tr[name] = _by_layer(jr[name], jrouters), _by_layer(tr[name], routers)
    jr["decode"] = [_by_layer(x, jrouters) for x in jr["decode"]]
    tr["decode"] = [_by_layer(x, routers) for x in tr["decode"]]
    return cfg, (want, jr), (got, tr)


def _reached(routes_a, routes_b, cfg, B=2):
    """Per output, the mask of what no differing route between two runs
    reaches, and the number of (layer, token) routes that differ."""
    n_diff = 0
    fwd_first = np.full(B, S_FWD)
    for d in _differ(routes_a["forward"], routes_b["forward"], cfg):
        n_diff += int(d.sum())
        for b, s in zip(*np.nonzero(d.reshape(B, S_FWD))):
            fwd_first[b] = min(fwd_first[b], s)
    first = np.full(B, N_PROMPT + N_DECODE)          # the row's first reached position
    for d in _differ(routes_a["prefill"], routes_b["prefill"], cfg):
        n_diff += int(d.sum())
        for b, s in zip(*np.nonzero(d.reshape(B, N_PROMPT))):
            first[b] = min(first[b], s)
    for i, (a, b_) in enumerate(zip(routes_a["decode"], routes_b["decode"])):
        for d in _differ(a, b_, cfg):
            n_diff += int(d.sum())
            if d.any():                               # the group is both rows' token
                first[:] = np.minimum(first, N_PROMPT + i)
    pos = np.arange(S_FWD)
    clean = dict(forward=pos[None, :] < fwd_first[:, None],
                 prefill=(first >= N_PROMPT)[:, None],
                 decode=(N_PROMPT + np.arange(N_DECODE))[None, :] < first[:, None])
    cache = pos[None, :] < first[:, None]             # (B, S) positions of the caches
    clean["prefill_cache"] = clean["decode_cache"] = cache
    return clean, n_diff


def _select(a, name, mask):
    if name.endswith("cache"):                        # (L, 2, B, S, KV, hd)
        return a.transpose(2, 3, 0, 1, 4, 5)[mask]
    return a[mask]


@pytest.mark.parametrize("which", MOE_ARCHS)
def test_moe_models_match_jax_in_f32(which):
    """Routes of forward, prefill and every decode step equal, then the
    outputs within 2e-4 (the caches within 2e-4 plus one bf16 ulp)."""
    cfg, (want, jr), (got, tr) = _both(which, "f32")
    clean, n_diff = _reached(jr, tr, cfg)
    assert n_diff == 0, f"{n_diff} (layer, token) routes differ from the reference's"
    assert len(tr["forward"]) == len(tr["prefill"]) == cfg.n_layers
    assert all(len(r) == cfg.n_layers for r in tr["decode"])
    for name in ("forward", "prefill", "decode"):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4, atol=2e-4, err_msg=name)
    for name in ("prefill_cache", "decode_cache"):
        ratio = np.abs(got[name] - want[name]) / (2e-4 + 2.0**-7 * np.abs(want[name]))
        assert ratio.max() <= 1.0, (name, ratio.max())
    drops = [1 - float(np.mean(_route_keys(e, cfg)[:, 2 * cfg.top_k:])) for _, e in
             tr["forward"]]
    assert max(drops) > 0           # capacity drops choices at the smoke size too


@pytest.mark.parametrize("which", MOE_ARCHS)
def test_moe_bf16_error_at_most_twice_the_jax_packages(which):
    runs = {}
    for dtype in ("f32", "bf16"):
        cfg, runs["jax", dtype], runs["torch", dtype] = _both(which, dtype)
    pairs = [(("jax", "f32"), ("jax", "bf16")), (("torch", "f32"), ("torch", "bf16")),
             (("jax", "bf16"), ("torch", "bf16")), (("jax", "f32"), ("torch", "f32"))]
    masks, counts = [], {}
    for a, b in pairs:
        clean, counts[a, b] = _reached(runs[a][1], runs[b][1], cfg)
        masks.append(clean)
    print(f"{which}: (layer, token) routes that differ: "
          + ", ".join(f"{'/'.join(a)} vs {'/'.join(b)} {n}" for (a, b), n in counts.items()))
    assert counts[("jax", "f32"), ("torch", "f32")] == 0
    compared = 0
    for name in runs["jax", "f32"][0]:
        mask = np.logical_and.reduce([m[name] for m in masks])
        if not mask.any():
            continue
        err = {pkg: float(np.abs(_select(runs[pkg, "bf16"][0][name], name, mask)
                                 - _select(runs[pkg, "f32"][0][name], name, mask)).max())
               for pkg in ("jax", "torch")}
        assert err["torch"] <= 2 * err["jax"], (name, err)
        compared += 1
    assert compared >= 3, compared      # forward, the caches, and more, each in part


@pytest.mark.parametrize("which", MOE_ARCHS)
def test_moe_lm_loss_and_gradients_match_jax(which):
    jcfg, cfg = _configs(which, "f32")
    jparams, params = _weights(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with _recording() as (jrec, trec):
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jtm.lm_loss(p, jcfg, b)))(
            jparams, {k: jnp.asarray(v) for k, v in nb.items()})
        loss, grads = optim.value_and_grad(
            lambda p, c, b: tm.lm_loss(p, c, b, device="cpu"))(params, cfg, nb)
    routers = _routers(jparams, jnp.float32)
    d = _differ(_by_layer(jrec, routers), _by_layer(trec, routers), cfg)
    assert len(d) == cfg.n_layers and sum(int(x.sum()) for x in d) == 0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    assert sorted(grads["layers"]) == sorted(jgrads["layers"])
    for path, g in want:
        keys = [str(getattr(p, "key", p)) for p in path]
        got = grads[keys[0]] if len(keys) == 1 else grads[keys[0]][keys[1]]
        err = np.abs(got.numpy() - g).max(initial=0.0)
        assert err <= 1e-4 * np.abs(g).max(initial=0.0) + 1e-12, f"d {'/'.join(keys)}: {err}"
    assert float(np.abs(grads["layers"]["router"].numpy()).max()) > 0


def test_init_tree_shapes_and_scale_rule():
    """The JAX tree, shapes and dtypes; each leaf's scale the reference's
    ``_init_linear`` rule (an expert stack (L, E, ., .) at 1/sqrt(E)), and
    the port's draws at that scale."""
    for which in MOE_ARCHS:
        jcfg, cfg = _configs(which, "f32")
        jparams = jtm.init(jax.random.PRNGKey(0), jcfg)
        params = tm.init(torch.Generator().manual_seed(0), cfg)
        shape_of = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)  # noqa
        assert shape_of(interop.params_to_numpy(params)) == shape_of(jparams)
        order = [p.split("/")[-1] for p in tm._shapes(cfg) if p.startswith("layers/")]
        assert order == ["ln_attn", "wq", "wk", "wv", "wo", "ln_mlp", "router", "w_gate",
                         "w_in", "w_out"]
        for path, shape in tm._shapes(cfg).items():
            name = path.split("/")[-1]
            if name in ("embed", "ln_attn", "ln_mlp", "final_ln"):
                continue
            key = jax.random.PRNGKey(1)
            want = float(jtm._init_linear(key, shape, jnp.float32).reshape(-1)[0]
                         / jax.random.normal(key, shape).reshape(-1)[0])
            assert abs(tm.init_scale(name, shape) - want) <= 1e-6 * want, (path, want)
            leaf = params["layers"][name] if path.startswith("layers/") else params[name]
            assert abs(float(leaf.std()) / want - 1) < 0.1, (path, float(leaf.std()), want)
        E = cfg.n_experts
        assert tm.init_scale("w_gate", tm._shapes(cfg)["layers/w_gate"]) == 1 / np.sqrt(E)


def test_full_configs_and_counts_match_jax():
    """Field for field the reference's configs (but ``micro_batches`` and
    ``fsdp``), parameter counts from shapes alone, and the registry."""
    counts = {"granite-moe-1b-a400m": (1_385_219_072, 479_249_408),
              "mixtral-8x7b": (46_702_792_704, 12_879_925_248)}
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "hd",
              "mlp_type", "rope_theta", "layer_pattern", "tie_embeddings", "n_experts",
              "top_k", "capacity_factor", "moe_group_size", "moe_impl", "moe_fused_combine",
              "aux_loss_weight", "remat", "q_chunk", "loss_chunk")
    for which in MOE_ARCHS:
        spec, jspec = REGISTRY[which], JREGISTRY[which]
        for make, jmake in ((spec.make_config, jspec.make_config),
                            (spec.make_smoke, jspec.make_smoke)):
            cfg, jcfg = make(), jmake()
            assert cfg.name == jcfg.name
            assert [getattr(cfg, f) for f in fields] == [getattr(jcfg, f) for f in fields]
            assert cfg.moe_cfg == moe.MoEConfig(**dataclasses.asdict(jcfg.moe_cfg))
        full = spec.make_config()
        assert (full.n_params(), full.n_active_params()) == counts[which]
        assert full.n_params() == jspec.make_config().n_params()
        assert full.n_active_params() == jspec.make_config().n_active_params()
        assert spec.family == jspec.family == "lm"
        assert [(s.name, s.kind, s.dims, s.skip) for s in spec.shapes] == \
            [(s.name, s.kind, s.dims, s.skip) for s in jspec.shapes]
    cut = dataclasses.replace(REGISTRY["mixtral-8x7b"].make_config(), n_layers=4)
    assert cut.n_params() == 6_067_228_672


def test_registry_covers_all_assigned_archs():
    """``tests/test_arch_smoke.py:121`` on the port's registry."""
    assigned = {"starcoder2-7b", "yi-9b", "gemma3-1b", "granite-moe-1b-a400m",
                "mixtral-8x7b", "pna", "mind", "autoint", "bst", "wide-deep"}
    assert assigned <= set(REGISTRY), assigned - set(REGISTRY)
    assert sum(len(s.shapes) for n, s in REGISTRY.items() if n in assigned) == 40


def _train(ckpt, *extra):
    """A trainer process at granite's smoke config (started, not awaited)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", "granite-moe-1b-a400m", "--steps", "6", "--batch", "2", "--seq", "16",
           "--ckpt-every", "2", "--quiet", "--ckpt-dir", str(ckpt), *extra]
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc):
    out, err = proc.communicate(timeout=300)
    return SimpleNamespace(returncode=proc.returncode, stdout=out, stderr=err)


def test_granite_trainer_resumes_bitwise(tmp_path):
    """``launch.train --arch granite-moe-1b-a400m`` at its smoke config: run
    B, killed after step 3 and resumed from step 2, ends with run A's
    step-6 arrays, bitwise.  Run A and run B's first part run side by side."""
    procs = _train(tmp_path / "a"), _train(tmp_path / "b", "--fail-at", "3")
    a, b = (_wait(p) for p in procs)
    assert a.returncode == 0, a.stderr
    assert b.returncode == 42 and "simulated preemption at step 3" in b.stdout, b.stderr
    b = _wait(_train(tmp_path / "b", "--resume"))
    assert b.returncode == 0 and "resumed from step 2" in b.stdout, b.stdout + b.stderr
    za = np.load(tmp_path / "a" / "step_00000006" / "arrays.npz")
    zb = np.load(tmp_path / "b" / "step_00000006" / "arrays.npz")
    assert sorted(za.files) == sorted(zb.files)
    assert "params/layers/router" in za.files and za["params/layers/w_out"].ndim == 4
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
