"""The LM family's per-position program on the one-process mesh: the port's
counterpart of the program GSPMD derives from ``rules.lm_param_specs``
and ``rules.lm_cache_spec`` for ``repro.launch.steps.build_lm``'s cells.

One process drives every position (``launch.mesh``), in lockstep: each
value of the program is a list, one tensor a running position, and each
operation runs at its position (``sharding.collectives.at``), so that
``launch.cost.analyze(mesh=)`` counts each device's work.  A position
holds its blocks of the parameters under the rules (``local``): column
blocks of ``wq``/``wk``/``wv``/``w_gate``/``w_in``, row blocks of
``wo``/``w_out``, a block of the vocabulary's rows of ``embed`` and
columns of ``lm_head``, with FSDP also a block of their other dim over
``data``.  The plan, layer by layer:

  * attention: the column-split projections of the normed input (entered
    through ``collectives.copy_to_all``, Megatron's f), the row-split
    ``wo`` and one all-reduce over the model axis (``reduce_to_all``,
    Megatron's g).  Where the heads split whole (``rules.heads_split``)
    a position attends its ``H / m`` heads against the kv heads they read,
    which it gathers where its block of ``wk``/``wv`` is not those
    (``rules.kv_split``; KV = 1, or KV not a multiple of m).  Where they do
    not (gemma3-1b's 4 and starcoder2-7b's 36 heads on 16 positions) a
    position attends all heads over its ``S / m`` query rows: its queries
    reach it by an all-to-all, the keys and values by an all-gather, and
    its outputs go back by an all-to-all, so that no position repeats
    another's attention work.
  * MLP: column-split ``w_gate``/``w_in``, row-split ``w_out``, one
    all-reduce.  MoE: every position routes all of its group's tokens
    (the global ranking: slots counted over all experts), then runs its
    ``E / m`` experts' capacity slots (expert parallelism) or its ``d_ff /
    m`` of every expert (tensor parallelism inside them); its part of the
    combine is summed by an all-reduce.  A group that spans data replicas
    (a decode step's B tokens) is gathered over the data axes first.
  * vocabulary: the lookup on a position's block of rows, masked outside
    it and all-reduced; the logits split by columns; the loss a
    vocab-parallel cross-entropy (the maximum and the sum of exponentials
    all-reduced) over ``loss_chunk`` chunks, so the whole logits never
    exist.  Prefill and decode return logits split over the model axis;
    the caller's join (``join``) is not counted.
  * FSDP: a weight's block is all-gathered over ``data`` before its layer
    (inside the layer's checkpoint, so the backward gathers it again); the
    gather's backward is the reduce-scatter of its gradient.
  * decode: the cache's sequence splits over the model axis (or, at batch
    1, over every axis): q, k and v are all-gathered, the position that
    owns ``cache_index`` writes the new slot, each position attends all
    heads over its slice of the cache, and the maxima, the sums and the
    outputs are all-reduced (flash-decoding's split-K).
  * prefill: kernel 7 (``ops.flash_attention``) at each position, on its
    heads where they split whole, else on its query rows (the kernel's
    ``q_offset``: rows ``lo ..`` against the keys before them); the new k
    and v reach the cache's layout (sequence over the model axis) by an
    all-to-all.

Every collective is one of ``sharding.collectives``, a
``torch.autograd.Function`` where a gradient passes it, so the backward's
collectives are counted too; sums add in position order, so a run
repeats bitwise.  A train cell's backward starts from every position's
copy of its replica's loss (each with cotangent 1): Megatron's f and g
then give each position its blocks' gradients, and every copy of a
replicated parameter the whole gradient.  On ``meta`` the first position
runs for all (``collectives.mirror``): every position's program is the
same up to which blocks it holds.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.transformer import attention as attn_lib
from repro_torch.models.transformer import moe as moe_lib
from repro_torch.models.transformer.model import _rms, cast_params
from repro_torch.optim.accumulate import microbatch
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sharding import collectives, rules

__all__ = ["Plan", "join"]


def _map(fn, tree: dict, specs: dict) -> dict:
    return {k: _map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


class Plan:
    """The plan of ``cfg`` on ``mesh`` (module docstring).  ``device``: where
    the parameters are (``meta``: the first position runs for all)."""

    def __init__(self, cfg, mesh, device):
        self.cfg, self.mesh = cfg, mesh
        self.m = m = rules.model_size(mesh)
        self.specs = rules.lm_param_specs(cfg, mesh)
        self.meta = torch.device(device).type == "meta"
        every = mesh.positions()
        self.index = {c: i for i, c in enumerate(every)}
        self.pos = every[:1] if self.meta else every
        self.maxis = mesh.axis_names.index("model")
        self.heads = rules.heads_split(cfg, mesh)
        self.kv_whole = rules.kv_split(cfg, mesh)
        self._groups: dict = {}
        for what, n in (("d_ff", cfg.d_ff), ("vocab_padded", cfg.vocab_padded),
                        ("kv columns", cfg.n_kv_heads * cfg.hd)):
            if n % m:
                raise ValueError(f"{cfg.name}: {what} {n} does not split over {m} positions")

    # -- positions ---------------------------------------------------------------
    def j(self, i: int) -> int:
        """The model coordinate of running position ``i``."""
        return self.pos[i][self.maxis]

    def each(self, fn, *lists) -> list:
        """``fn(i, *(l[i] ...))`` at every running position ``i``."""
        out = []
        for i, p in enumerate(self.pos):
            with collectives.at(p):
                out.append(fn(i, *(lst[i] for lst in lists)))
        return out

    def over(self, axes, coll, xs: list, **kw) -> list:
        """``coll(group's tensors, group's positions, **kw)`` over every group
        of positions along ``axes`` that a running position is in; a
        position that does not run (on ``meta``) lends the first's tensor."""
        out = [None] * len(xs)
        if axes not in self._groups:
            self._groups[axes] = self.mesh.groups(axes)
        for group in self._groups[axes]:
            idx = [self.index[c] for c in group]
            if all(i >= len(xs) for i in idx):
                continue
            got = coll([xs[i] if i < len(xs) else xs[0] for i in idx], group, **kw)
            for i, t in zip(idx, got):
                if i < len(xs):
                    out[i] = t
        return out

    def mirror(self) -> None:
        if self.meta:
            collectives.mirror(self.mesh, self.pos)

    # -- parameters ----------------------------------------------------------------
    def local(self, params: dict, grad: bool = False) -> list:
        """Every running position's blocks of ``params`` (views), as leaves of
        their own when ``grad``."""
        out = []
        for p in self.pos:
            def block(leaf, spec, p=p):
                t = rules.local_block(leaf, spec, self.mesh, p)
                return t.detach().requires_grad_() if grad else t
            out.append(_map(block, params, self.specs))
        return out

    def cast(self, local: list) -> list:
        return self.each(lambda i, lp: cast_params(lp, self.cfg.compute_dtype), local)

    def weight(self, cps: list, key: str, layer: int | None = None) -> list:
        """Every running position's model block of a weight (layer
        ``layer``'s of a stacked one), all-gathered over ``data`` where
        FSDP splits it."""
        if layer is None:
            ws, spec = [cp[key] for cp in cps], self.specs[key]
        else:
            ws = self.each(lambda i, cp: cp["layers"][key][layer], cps)
            spec = self.specs["layers"][key][1:]
        dim = next((d for d, e in enumerate(spec) if "data" in rules.entry_axes(e)), None)
        if dim is None or self.mesh.shape.get("data", 1) == 1:
            return ws
        return self.over("data", collectives.gather, ws, dim=dim)

    def layer(self, cps: list, layer: int) -> list:
        names = list(cps[0]["layers"])
        got = {n: self.weight(cps, n, layer) for n in names}
        return [{n: got[n][i] for n in names} for i in range(len(self.pos))]

    # -- embedding and logits --------------------------------------------------------
    def _vocab(self, i: int) -> tuple[int, int]:
        n = self.cfg.vocab_padded // self.m
        return self.j(i) * n, (self.j(i) + 1) * n

    def embed(self, cps: list, tokens: list) -> list:
        """The token embeddings: each position's rows of the vocabulary,
        zero elsewhere, all-reduced over the model axis."""
        cfg = self.cfg
        table = self.weight(cps, "embed")

        def lookup(i, t, tab):
            lo, hi = self._vocab(i)
            mine = (t >= lo) & (t < hi)
            rows = tab[torch.where(mine, t - lo, torch.zeros_like(t))]
            return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                  device=rows.device))

        x = self.over("model", collectives.reduce_to_all, self.each(lookup, tokens, table))
        if cfg.tie_embeddings:
            x = self.each(lambda i, x_: x_ * torch.tensor(np.sqrt(cfg.d_model), dtype=x_.dtype,
                                                          device=x_.device), x)
        return x

    def logits(self, cps: list, x: list, head=None) -> list:
        """Each position's columns of the logits (B, s, vocab_padded / m),
        the padded columns at -1e30.  ``head``: the unembedding blocks,
        when the caller has them already."""
        cfg = self.cfg
        if head is None:
            head = self.head(cps)
        xn = self.each(lambda i, x_, cp: _rms(x_, cp["final_ln"]), x, cps)
        xf = self.over("model", collectives.copy_to_all, xn)

        def columns(i, x_, w):
            out = x_ @ w
            lo = self._vocab(i)[0]
            if cfg.vocab_padded != cfg.vocab and lo + out.shape[-1] > cfg.vocab:
                col = torch.arange(lo, lo + out.shape[-1], device=out.device)
                out = torch.where(col < cfg.vocab, out, torch.full_like(out, -1e30))
            return out

        return self.each(columns, xf, head)

    def head(self, cps: list) -> list:
        if self.cfg.tie_embeddings:
            return self.each(lambda i, w: w.T, self.weight(cps, "embed"))
        return self.weight(cps, "lm_head")

    def _chunk_ce(self, cps: list, head: list, x: list, labels: list) -> list:
        """Each position's copy of one chunk's summed cross-entropy, f32:
        the logits' maximum and the sum of their exponentials all-reduced
        over the model axis, and the gold logit from the position that
        holds its column."""
        lg = self.each(lambda i, t: t.float(), self.logits(cps, x, head))
        top = self.over("model", collectives.all_reduce,
                        self.each(lambda i, t: t.detach().amax(-1), lg), op="max")
        sums = self.over("model", collectives.reduce_to_all,
                         self.each(lambda i, t, mx: torch.exp(t - mx[..., None]).sum(-1), lg, top))

        def gold(i, t, lab):
            lo, hi = self._vocab(i)
            mine = (lab >= lo) & (lab < hi)
            got = torch.gather(t, -1, torch.where(mine, lab - lo, torch.zeros_like(lab))[..., None])
            return torch.where(mine, got[..., 0], torch.zeros((), device=t.device))

        golds = self.over("model", collectives.reduce_to_all, self.each(gold, lg, labels))
        return self.each(lambda i, mx, s, g: ((mx + torch.log(s)) - g).sum(), top, sums, golds)

    # -- attention --------------------------------------------------------------------
    def _projections(self, lps: list, x: list) -> list:
        h = self.each(lambda i, x_, lp: _rms(x_, lp["ln_attn"]), x, lps)
        hf = self.over("model", collectives.copy_to_all, h)
        return [self.each(lambda i, h_, lp, n=n: h_ @ lp[n], hf, lps) for n in ("wq", "wk", "wv")]

    def _kv_columns(self, j: int) -> tuple[int, int]:
        """The kv columns that model position ``j``'s query heads read."""
        lo, hi = rules.kv_heads_read(self.cfg, rules.position_heads(self.cfg, self.mesh, j))
        return lo * self.cfg.hd, hi * self.cfg.hd

    def _read_kv(self, k: list) -> list:
        """Each position's kv columns: its block where it is those,
        else gathered from the positions that hold them."""
        if self.kv_whole:
            return k

        def gather(xs, group):
            need = [self._kv_columns(p[self.maxis]) for p in group]
            return collectives.gather(xs, group, dim=2, need=need)

        return self.over("model", gather, k)

    def _grouped(self, i: int, k, v):
        """(k, v, kv heads) for position ``i``'s query heads: its kv heads
        as read, or one a query head where they do not group evenly."""
        cfg = self.cfg
        h0, h1 = rules.position_heads(cfg, self.mesh, self.j(i))
        k0, k1 = rules.kv_heads_read(cfg, (h0, h1))
        G = cfg.n_heads // cfg.n_kv_heads
        read = [h // G - k0 for h in range(h0, h1)]
        n, per = k1 - k0, (h1 - h0) // (k1 - k0)
        if (h1 - h0) % n == 0 and read == [a // per for a in range(h1 - h0)]:
            return k, v, n
        idx = torch.tensor(read, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx), h1 - h0

    def _head_attention(self, q, k, v, positions, window, kernel: bool) -> list:
        cfg = self.cfg
        B, S, hd, theta = q[0].shape[0], q[0].shape[1], cfg.hd, cfg.rope_theta
        k, v = self._read_kv(k), self._read_kv(v)

        def attend(i, q_, k_, v_):
            q_ = attn_lib.rope(q_.reshape(B, S, -1, hd), positions, theta)
            k_ = attn_lib.rope(k_.reshape(B, S, -1, hd), positions, theta)
            k_, v_, n = self._grouped(i, k_, v_.reshape(B, S, -1, hd))
            if kernel:
                o = ops.flash_attention(q_.contiguous(), k_.contiguous(), v_.contiguous(),
                                        window=window)
            else:
                o = attn_lib.gqa_attention(q_, k_, v_, n_kv_heads=n, q_positions=positions,
                                           k_positions=positions, window=window,
                                           q_chunk=cfg.q_chunk)
            return o.reshape(B, S, -1)

        return self.each(attend, q, k, v)

    def _row_attention(self, q, k, v, window, kernel: bool) -> list:
        """All heads over each position's ``S / m`` query rows: queries by an
        all-to-all, keys and values by an all-gather, the outputs back by an
        all-to-all (each position's columns of every row).  ``kernel``:
        kernel 7 at the rows' offset."""
        cfg = self.cfg
        B, S, hd = q[0].shape[0], q[0].shape[1], cfg.hd
        if S % self.m:
            raise ValueError(f"{cfg.name}: {cfg.n_heads} heads do not split over {self.m} "
                             f"positions, and its {S} query rows do not either")
        rows = S // self.m
        q = self.over("model", collectives.all_to_all, q, split_dim=1, cat_dim=2)
        k = self.over("model", collectives.gather, k, dim=2)
        v = self.over("model", collectives.gather, v, dim=2)

        def attend(i, q_, k_, v_):
            lo = self.j(i) * rows
            return _rows_attention(cfg, q_, k_, v_, lo, window, kernel)

        out = self.each(attend, q, k, v)
        return self.over("model", collectives.all_to_all, out, split_dim=2, cat_dim=1)

    def attention(self, lps: list, x: list, window, *, kernel: bool = False,
                  cache: tuple | None = None) -> list:
        """One layer's attention block added to ``x``.  ``cache`` (the
        cache's blocks, the layer): prefill also writes its k and v there, in
        the cache's layout."""
        B, S = x[0].shape[:2]
        q, k, v = self._projections(lps, x)
        positions = torch.arange(S, device=x[0].device)
        if cache is not None:
            self._to_cache(k, v, *cache, S)
        if self.heads:
            o = self._head_attention(q, k, v, positions, window, kernel)
        else:
            o = self._row_attention(q, k, v, window, kernel)
        part = self.each(lambda i, o_, lp: o_ @ lp["wo"], o, lps)
        y = self.over("model", collectives.reduce_to_all, part)
        return self.each(lambda i, x_, y_: x_ + y_, x, y)

    def seq(self, p: tuple) -> tuple[int, int]:
        """(start, stop) of the cache's sequence that position ``p`` holds
        (``rules.cache_block`` of the call's ``cache_shape``)."""
        return rules.cache_block(self.mesh, *self.cache_shape, p)["seq"]

    def _to_cache(self, k, v, blocks: list, layer: int, S: int) -> None:
        """Prefill's k and v (each position's columns of every row) to each
        position's block of the cache (its rows of the sequence, every
        column), by an all-to-all; keys rope'd there."""
        cfg = self.cfg

        def exchange(xs, group):
            sizes = [max(0, min(hi, S) - lo) for lo, hi in map(self.seq, group)]
            return collectives.all_to_all(xs, group, split_dim=1, cat_dim=2, sizes=sizes)

        for slot, t in ((0, k), (1, v)):
            def write(i, piece, slot=slot):
                lo = self.seq(self.pos[i])[0]
                B, n = piece.shape[:2]
                piece = piece.reshape(B, n, cfg.n_kv_heads, cfg.hd)
                if slot == 0:
                    piece = attn_lib.rope(piece, torch.arange(lo, lo + n, device=piece.device),
                                          cfg.rope_theta)
                blocks[i][layer, slot, :, :n] = piece.to(blocks[i].dtype)

            self.each(write, self.over("model", exchange, t))

    # -- MLP ----------------------------------------------------------------------------
    def mlp(self, lps: list, x: list, rows_split: bool) -> list:
        """One layer's MLP block added to ``x``."""
        cfg = self.cfg
        h = self.each(lambda i, x_, lp: _rms(x_, lp["ln_mlp"]), x, lps)
        if cfg.is_moe:
            y = self._moe(lps, h, rows_split)
            return self.each(lambda i, x_, y_: x_ + y_, x, y)
        hf = self.over("model", collectives.copy_to_all, h)

        def act(i, h_, lp):
            if cfg.mlp_type == "swiglu":
                a = F.silu(h_ @ lp["w_gate"]) * (h_ @ lp["w_in"])
            elif cfg.mlp_type == "geglu":
                a = F.gelu(h_ @ lp["w_gate"], approximate="tanh") * (h_ @ lp["w_in"])
            else:
                a = F.gelu(h_ @ lp["w_in"], approximate="tanh")
            return a @ lp["w_out"]

        y = self.over("model", collectives.reduce_to_all, self.each(act, hf, lps))
        return self.each(lambda i, x_, y_: x_ + y_, x, y)

    def _moe(self, lps: list, h: list, rows_split: bool) -> list:
        """The MoE FFN of ``h`` (B, S, d) at each position: the group's
        routes from every expert's logits (``moe.top_experts``, as one
        device routes), then the position's experts (or
        its slice of every expert), their part summed over the model axis.
        Groups of ``min(group_size, T)`` of the call's T tokens (over every
        replica where the rows split over data), as one device groups them;
        a replica whose tokens are not whole groups gathers the data axes'
        first."""
        cfg, mcfg = self.cfg, self.cfg.moe_cfg
        B, S, d = h[0].shape
        dp = self.mesh.dp if rows_split else 1
        T_r = B * S
        gsz = moe_lib.group_size(mcfg, T_r * dp)
        gcfg = dataclasses.replace(mcfg, group_size=gsz)
        flat = self.each(lambda i, t: t.reshape(-1, d), h)
        gathered = T_r % gsz != 0
        if gathered:
            flat = self.over(rules.dp_axes(self.mesh), collectives.gather, flat, dim=0)
        grouped = self.each(lambda i, t: t.reshape(-1, gsz, d), flat)
        logits = self.each(lambda i, t, lp: moe_lib.router_logits(t, lp["router"]), grouped, lps)
        experts = self.each(lambda i, lg: moe_lib.top_experts(lg, mcfg.top_k), logits)
        gates = self.each(lambda i, lg, e: moe_lib.gates_of(lg, e, gcfg), logits, experts)
        xf = self.over("model", collectives.copy_to_all, grouped)
        gf = self.over("model", collectives.copy_to_all, gates)
        ep = rules.expert_parallel(cfg, self.mesh)

        def experts_out(i, x_, g_, e_, lp):
            first = rules.position_experts(cfg, self.mesh, self.j(i))[0] if ep else 0
            return moe_lib.expert_outputs(x_, g_, e_, lp["w_gate"], lp["w_in"], lp["w_out"],
                                          gcfg, first=first)

        part = self.each(experts_out, xf, gf, experts, lps)
        y = self.over("model", collectives.reduce_to_all, part)

        def mine(i, y_):
            y_ = y_.reshape(-1, d)
            if gathered:
                r = self.index[self.pos[i]] // self.m
                y_ = y_[r * T_r:(r + 1) * T_r]
            return y_.reshape(B, S, d)

        return self.each(mine, y)

    # -- entry points ---------------------------------------------------------------------
    def _trunk(self, cps: list, tokens: list, rows_split: bool, remat: bool,
               kernel: bool = False, cache=None) -> list:
        x = self.embed(cps, tokens)
        for li in range(self.cfg.n_layers):
            def run(*xs, li=li):
                lps = self.layer(cps, li)
                step = None if cache is None else (cache, li)
                y = self.attention(lps, list(xs), self.cfg.window(li), kernel=kernel, cache=step)
                return tuple(self.mlp(lps, y, rows_split))

            x = list(checkpoint(run, *x, use_reentrant=False) if remat else run(*x))
        return x

    def loss(self, cps: list, tokens: list, labels: list) -> list:
        """Each position's copy of its replica's mean next-token
        cross-entropy (``model.lm_loss`` on the replica's rows): layers under
        ``torch.utils.checkpoint`` when ``cfg.remat``, the cross-entropy over
        chunks of ``loss_chunk`` positions, each checkpointed."""
        cfg = self.cfg
        x = self._trunk(cps, tokens, True, cfg.remat)
        B, S, _ = x[0].shape
        c = min(cfg.loss_chunk, S)
        if S % c:
            raise ValueError(f"sequence length {S} is not a multiple of loss_chunk {c}")
        head = self.head(cps)
        total = self.each(lambda i, t: torch.zeros((), dtype=torch.float32, device=t.device), x)
        for a in range(0, S, c):
            xs = self.each(lambda i, t: t[:, a:a + c], x)
            ls = self.each(lambda i, t: t[:, a:a + c], labels)
            part = checkpoint(lambda *args: tuple(self._chunk_ce(
                cps, head, list(args[:len(xs)]), list(args[len(xs):]))), *xs, *ls,
                use_reentrant=False)
            total = self.each(lambda i, t, p: t + p, total, list(part))
        return self.each(lambda i, t: t / (B * S), total)

    def grads(self, params: dict, tokens: list, labels: list, n_micro: int):
        """(each position's loss copy, each position's gradient tree of its
        blocks) summed over ``n_micro`` microbatches of its replica's rows
        (``(B_r, ...) -> (B_r / n, n, ...)``, microbatch ``i`` ``[:, i]``, the
        global split's rows on the replica) and scaled by ``1 / n``, before
        any reduction over the data axes."""
        local = self.local(params, grad=True)
        leaves = [tree_leaves(lp) for lp in local]
        flat = [x for ls in leaves for x in ls]
        tot_l = self.each(lambda i, ls: torch.zeros((), device=ls[0].device), leaves)
        tot_g = self.each(lambda i, ls: [torch.zeros_like(x) for x in ls], leaves)
        # on meta the first microbatch stands for all: they run one program
        with collectives.repeated(n_micro) if self.meta else contextlib.nullcontext():
            for mb in range(1 if self.meta else n_micro):
                tk = self.each(lambda i, t: microbatch(t, n_micro, mb), tokens)
                lb = self.each(lambda i, t: microbatch(t, n_micro, mb), labels)
                with torch.enable_grad():
                    losses = self.loss(self.cast(local), tk, lb)
                    gs = torch.autograd.grad(losses, flat, [torch.ones_like(x) for x in losses],
                                             allow_unused=True)
                gs = iter(torch.zeros_like(x) if g is None else g for x, g in zip(flat, gs))
                per = [[next(gs) for _ in ls] for ls in leaves]
                tot_g = self.each(lambda i, t, g: [a + b for a, b in zip(t, g)], tot_g, per)
                tot_l = self.each(lambda i, t, x: t + x.detach(), tot_l, losses)
        inv = 1.0 / n_micro
        tot_l = self.each(lambda i, t: t * inv, tot_l)
        tot_g = self.each(lambda i, g: [x * inv for x in g], tot_g)
        return tot_l, [_rebuild(lp, g) for lp, g in zip(local, tot_g)]

    @torch.no_grad()
    def prefill(self, params: dict, tokens: list, blocks: list, cache_shape: tuple) -> list:
        """Each position's columns of the last position's logits; its block
        of the (batch, max_seq) ``cache_shape`` cache written (``blocks``:
        views, zeros past the prompt)."""
        self.cache_shape = cache_shape
        cps = self.cast(self.local(params))
        x = self._trunk(cps, tokens, True, False, kernel=True, cache=blocks)
        return self.logits(cps, self.each(lambda i, t: t[:, -1:, :], x))

    @torch.no_grad()
    def decode(self, params: dict, tokens: list, blocks: list, index: int,
               cache_shape: tuple, rows_split: bool) -> list:
        """One decode step: each position's columns of the logits; the new
        k and v written at ``index`` by the position that owns the slot."""
        cfg = self.cfg
        self.cache_shape = cache_shape
        cps = self.cast(self.local(params))
        x = self.embed(cps, tokens)
        axes = "model" if rows_split else tuple(self.mesh.axis_names)
        pos = torch.full((x[0].shape[0], 1), index, device=x[0].device)
        for li in range(cfg.n_layers):
            lps = self.layer(cps, li)
            q, k, v = self._projections(lps, x)
            q, k, v = (self.over("model", collectives.gather, t, dim=2) for t in (q, k, v))
            o = self._split_k(q, k, v, blocks, li, index, pos, axes, cfg.window(li))
            part = self.each(lambda i, o_, lp: o_ @ lp["wo"], o, lps)
            y = self.over("model", collectives.reduce_to_all, part)
            x = self.mlp(lps, self.each(lambda i, x_, y_: x_ + y_, x, y), rows_split)
        return self.logits(cps, x)

    def _split_k(self, q, k, v, blocks, layer, index, pos, axes, window) -> list:
        """Decode's attention, all heads, over each position's slice of the
        cache: the new slot written by its owner, the maxima, the sums and
        the outputs all-reduced over ``axes``; each position's rows of
        ``wo``'s input."""
        cfg = self.cfg
        B, H, KV, hd = q[0].shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.hd
        G, scale = H // KV, 1.0 / np.sqrt(hd)

        def scores(i, q_, k_, v_):
            q_ = attn_lib.rope(q_.reshape(B, 1, H, hd), pos, cfg.rope_theta)
            k_ = attn_lib.rope(k_.reshape(B, 1, KV, hd), pos, cfg.rope_theta)
            lo, hi = self.seq(self.pos[i])
            blk = blocks[i]
            if lo <= index < hi:
                blk[layer, 0, :, index - lo] = k_[:, 0].to(blk.dtype)
                blk[layer, 1, :, index - lo] = v_.reshape(B, KV, hd).to(blk.dtype)
            kc = blk[layer, 0].to(q_.dtype)
            s = torch.einsum("bqkgh,bskh->bkgqs", q_.reshape(B, 1, KV, G, hd), kc).float() * scale
            k_pos = torch.arange(lo, hi, device=s.device)
            mask = k_pos <= index
            if window is not None:
                mask = mask & (k_pos > index - window)
            return torch.where(mask, s, torch.full_like(s, attn_lib.NEG_INF))

        s = self.each(scores, q, k, v)
        top = self.over(axes, collectives.all_reduce,
                        self.each(lambda i, t: t.amax(-1), s), op="max")
        p = self.each(lambda i, t, mx: torch.exp(t - mx[..., None]), s, top)
        tot = self.over(axes, collectives.reduce_to_all, self.each(lambda i, t: t.sum(-1), p))

        def outputs(i, p_, l_, v_):
            vc = blocks[i][layer, 1].to(v_.dtype)
            probs = (p_ / l_[..., None]).to(vc.dtype)
            return torch.einsum("bkgqs,bskh->bqkgh", probs, vc).reshape(B, 1, H * hd)

        o = self.over(axes, collectives.reduce_to_all, self.each(outputs, p, tot, v))
        width = H * hd // self.m
        return self.each(lambda i, o_: o_[..., self.j(i) * width:(self.j(i) + 1) * width], o)


def _rebuild(tree: dict, leaves: list) -> dict:
    it = iter(leaves)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return walk(tree)


def _rows_attention(cfg, q, k, v, lo: int, window, kernel: bool):
    """Causal (windowed) GQA of the query rows ``lo ..`` (q (B, rows,
    H hd)) against every key before them (k, v (B, S, KV hd)), rope'd here:
    (B, rows, H hd) through kernel 7 at offset ``lo`` (``kernel``), else
    ``q_chunk`` rows at a time of the plain attention, each against the
    keys it can see."""
    B, rows, _ = q.shape
    S, H, KV, hd = k.shape[1], cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = q.device
    q = attn_lib.rope(q.reshape(B, rows, H, hd), torch.arange(lo, lo + rows, device=dev),
                      cfg.rope_theta)
    k = attn_lib.rope(k.reshape(B, S, KV, hd), torch.arange(S, device=dev), cfg.rope_theta)
    v = v.reshape(B, S, KV, hd)
    if kernel:
        return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   window=window, q_offset=lo).reshape(B, rows, H * hd)
    q = q.reshape(B, rows, KV, H // KV, hd)
    c = min(cfg.q_chunk or rows, rows)
    outs = []
    for a in range(0, rows, c):
        b = min(a + c, rows)
        first = 0 if window is None else max(0, lo + a - window + 1)
        stop = lo + b
        q_pos = torch.arange(lo + a, stop, device=dev).expand(B, b - a)
        k_pos = torch.arange(first, stop, device=dev).expand(B, stop - first)
        outs.append(attn_lib._attend(q[:, a:b], k[:, first:stop], v[:, first:stop], q_pos,
                                     k_pos, window, 1.0 / np.sqrt(hd)))
    return torch.cat(outs, 1).reshape(B, rows, H * hd)


def join(plan: Plan, parts: list, rows_split: bool) -> torch.Tensor:
    """The one process's copy of a model-split output (each position's
    columns, each replica's rows), not counted: on ``meta`` an empty
    tensor of its shape."""
    m, dp = plan.m, plan.mesh.dp if rows_split else 1
    shape = list(parts[0].shape)
    shape[-1] *= m
    shape[0] *= dp
    with collectives.at(collectives.OFF):
        if plan.meta:
            return parts[0].new_empty(shape)
        reps = [torch.cat(parts[r * m:(r + 1) * m], -1) for r in range(plan.mesh.dp)]
        return torch.cat(reps, 0) if rows_split else reps[0]
