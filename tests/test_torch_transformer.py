"""The port's LM family (``repro_torch.models.transformer``,
``repro_torch.configs.gemma3_1b``) against the JAX package's, on the CPU.

Both packages get one set of weights (the JAX ``init``, through
``interop``) and the same numpy tokens.  On the CPU the port's prefill
and forward attend through the flash-attention kernel's plain version;
the JAX package's through its chunked ``gqa_attention``.  Bounds:

  * attention (``gqa_attention``, ``decode_attention``), f32: 1e-5;
  * ``forward``, ``prefill`` and 6 ``decode_step``s with f32 compute: 2e-4,
    the bound of ``test_transformer.py::test_pattern_scan_matches_unrolled``,
    on the logits; the bf16 caches within 2e-4 plus one bf16 ulp;
  * bf16 compute: each package against its own f32 run, the port's largest
    error at most 2x the JAX package's (JAX's ``_attend`` rounds the scores
    to bf16, the port's flash path keeps them in f32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gemma3_1b as jgemma  # noqa: E402
from repro.models.transformer import attention as jattn  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import gemma3_1b  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import attention as tattn  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402

from test_torch_parity import to_np  # noqa: E402

CPU = "cpu"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# tests/test_transformer.py's _tiny, in both packages' field names
TINY = dict(name="t", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
            mlp_type="swiglu", layer_pattern=(None,))
TINY_DECODE = dict(TINY, layer_pattern=(4, None), mlp_type="geglu", tie_embeddings=True,
                   n_layers=5)


def _configs(which: str, dtype: str):
    """(JAX config, port config) of one model at one compute dtype."""
    jdt, tdt = DTYPES[dtype]
    if which == "smoke":
        return (dataclasses.replace(jgemma.make_smoke(), compute_dtype=jdt),
                dataclasses.replace(gemma3_1b.make_smoke(), compute_dtype=tdt))
    fields = {"tiny": TINY, "tiny-decode": TINY_DECODE}[which]
    return (jtm.TransformerConfig(**fields, compute_dtype=jdt, q_chunk=4),
            tm.TransformerConfig(**fields, compute_dtype=tdt))


def _weights(jcfg, seed=0):
    jparams = jtm.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, interop.params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd), dtype=np.float32) for n in (H, KV, KV))


def _close(got, want, tol):
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("S,H,KV,hd,window,q_chunk", [
    (24, 4, 2, 8, None, None),
    (24, 4, 2, 8, None, 8),
    (24, 4, 2, 8, None, 7),       # padded chunks
    (32, 2, 2, 8, 8, 8),          # MHA, window slices each chunk's keys
    (40, 4, 1, 16, 6, 8),
])
def test_gqa_attention_matches_jax(S, H, KV, hd, window, q_chunk):
    q, k, v = _qkv(1, 2, S, H, KV, hd)
    pos = np.arange(S)
    want = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_kv_heads=KV,
                               q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
                               window=window, q_chunk=q_chunk)
    t = torch.from_numpy
    got = tattn.gqa_attention(t(q), t(k), t(v), n_kv_heads=KV, q_positions=t(pos),
                              k_positions=t(pos), window=window, q_chunk=q_chunk)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_and_rope_match_jax(window):
    S, H, KV, hd, idx = 16, 4, 2, 8, 11
    q, k, v = _qkv(2, 2, S, H, KV, hd)
    q = q[:, :1]
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  n_kv_heads=KV, cache_index=jnp.asarray(idx), window=window)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 n_kv_heads=KV, cache_index=idx, window=window)
    _close(got, want, 1e-5)
    pos = np.arange(S)
    _close(tattn.rope(torch.from_numpy(k), torch.from_numpy(pos), 1e4),
           jattn.rope(jnp.asarray(k), jnp.asarray(pos), 1e4), 1e-5)


# -- the model ------------------------------------------------------------------

def test_init_has_the_jax_tree_and_counts():
    for which in ("smoke", "tiny"):
        jcfg, cfg = _configs(which, "f32")
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            jtm.init(jax.random.PRNGKey(0), jcfg))
        got = interop.params_to_numpy(tm.init(torch.Generator().manual_seed(0), cfg))
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), got) == want
        assert cfg.n_params() == jcfg.n_params()
    assert gemma3_1b.make_config().n_params() == jgemma.make_config().n_params() == 999_812_736


def test_interop_round_trips_a_nested_tree():
    jcfg, _ = _configs("smoke", "f32")
    jparams, params = _weights(jcfg)
    back = interop.params_to_numpy(params)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    assert all(np.array_equal(a, b) for a, b in zip(flat_j, flat_b))


_jforward = jax.jit(jtm.forward, static_argnums=1)
_jprefill = jax.jit(jtm.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jtm.decode_step, static_argnums=1)


def _run(pkg, cfg, params, toks, n_prompt, **kw):
    """forward logits, prefill (logits, cache) on the first ``n_prompt``
    tokens, and the logits of one decode step per remaining token."""
    S = toks.shape[1]
    if pkg == "jax":
        toks = jnp.asarray(toks)
        fwd = _jforward(params, cfg, toks)
        lg, cache = _jprefill(params, cfg, toks[:, :n_prompt], S)
        pre = (lg, cache)
        steps = []
        for t in range(n_prompt, S):
            lg, cache = _jdecode(params, cfg, toks[:, t:t + 1], cache, jnp.asarray(t))
            steps.append(lg)
    else:
        toks = torch.from_numpy(toks)
        fwd = tm.forward(params, cfg, toks, **kw)
        lg, cache = tm.prefill(params, cfg, toks[:, :n_prompt], S, **kw)
        pre = (lg, cache.clone())
        steps = []
        for t in range(n_prompt, S):
            lg, cache = tm.decode_step(params, cfg, toks[:, t:t + 1], cache, t, **kw)
            steps.append(lg)
    f32 = lambda a: to_np(a.float() if hasattr(a, "float") else a).astype(np.float32)  # noqa: E731
    logits = dict(forward=f32(fwd), prefill=f32(pre[0]), decode=np.stack([f32(s) for s in steps]))
    for lg in logits.values():                   # pad columns masked out
        assert (lg[..., cfg.vocab:] <= -1e29).all()
    return dict({name: lg[..., :cfg.vocab] for name, lg in logits.items()},
                prefill_cache=f32(pre[1]), decode_cache=f32(cache))


CASES = [("smoke", 13, 7), ("tiny", 12, 6), ("tiny-decode", 12, 6)]


@pytest.mark.parametrize("which,S,n_prompt", CASES)
def test_prefill_decode_forward_match_jax_in_f32(which, S, n_prompt):
    jcfg, cfg = _configs(which, "f32")
    jparams, params = _weights(jcfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    ops.reset_launches()
    want = _run("jax", jcfg, jparams, toks, n_prompt)
    got = _run("torch", cfg, params, toks, n_prompt, device=CPU)
    for name in ("forward", "prefill", "decode"):
        _close(got[name], want[name], 2e-4)
    # the caches hold bf16 roundings of f32 values that agree within 2e-4,
    # so an entry may also sit one bf16 ulp (at most 2^-7 |x|) away
    for name in ("prefill_cache", "decode_cache"):
        ratio = np.abs(got[name] - want[name]) / (2e-4 + 2.0**-7 * np.abs(want[name]))
        assert ratio.max() <= 1.0, (name, ratio.max())
    assert sum(ops.LAUNCHES.values()) == 0          # the CPU runs the plain version


@pytest.mark.parametrize("which,S,n_prompt", CASES)
def test_bf16_error_at_most_twice_the_jax_packages(which, S, n_prompt):
    toks = np.random.default_rng(4).integers(0, 97, (2, S)).astype(np.int32)
    out = {}
    for dtype in ("f32", "bf16"):
        jcfg, cfg = _configs(which, dtype)
        jparams, params = _weights(jcfg, seed=1)
        out["jax", dtype] = _run("jax", jcfg, jparams, toks, n_prompt)
        out["torch", dtype] = _run("torch", cfg, params, toks, n_prompt, device=CPU)
    for name in out["jax", "f32"]:
        err = {pkg: float(np.abs(out[pkg, "bf16"][name] - out[pkg, "f32"][name]).max())
               for pkg in ("jax", "torch")}
        assert err["torch"] <= 2 * err["jax"], (name, err)


def test_prefill_attends_through_the_kernel_entry_point(monkeypatch):
    _, cfg = _configs("smoke", "f32")
    params = tm.init(torch.Generator().manual_seed(0), cfg)
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, window=None):
        calls.append((tuple(q.shape), window))
        return real(q, k, v, window=window)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = torch.randint(0, cfg.vocab, (2, 11), generator=torch.Generator().manual_seed(0))
    tm.prefill(params, cfg, toks, 16, device=CPU)
    assert calls == [((2, 11, 4, 16), cfg.window(i)) for i in range(cfg.n_layers)]
    assert [w for _, w in calls] == [8, 8, 8, 8, 8, None, 8, 8]


def test_what_is_not_ported_raises():
    """An MoE model's tokens that do not split into whole groups raise (the
    reference asserts, and never pads); so does a prompt past the cache."""
    _, cfg = _configs("smoke", "f32")
    moe = dataclasses.replace(cfg, n_experts=4, top_k=2, moe_group_size=8)
    params = tm.init(torch.Generator().manual_seed(0), moe)
    with pytest.raises(ValueError, match="12 tokens do not split into MoE groups of 8"):
        tm.prefill(params, moe, np.zeros((2, 6), np.int64), 8, device=CPU)
    with pytest.raises(ValueError, match="12 tokens do not split into MoE groups of 8"):
        tm.forward(params, moe, np.zeros((1, 12), np.int64), device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        tm.prefill(params, cfg, np.zeros((1, 9), np.int64), 8, device=CPU)
