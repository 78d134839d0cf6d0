"""Every LM cell counted a device of the production meshes on ``meta``
(``launch.dryrun.count_cell(mesh_name=)``): the (16, 16) and (2, 16, 16)
meshes of 256 and 512 positions, mixtral-8x7b at full depth among them.

A device's parameter, optimizer-state, input and cache bytes are derived
here from the rules (``sharding.rules``) and the shapes; its collective
bytes by kind from the plan of ``models.transformer.parallel``, one
formula a kind (``plan_bytes``), at the first position (each position's
program is the same up to which blocks it holds).  The count runs one
position and one microbatch for all (``collectives.mirror``,
``collectives.repeated``), about 170 s for the 34 records here.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.sharding import collectives, rules  # noqa: E402

LM_CELLS = [(a, s) for a, s, _ in steps.all_cells() if REGISTRY[a].family == "lm"]
MESHES = {"single": 256, "multi": 512}

# a device's f32 parameters on either mesh (the same on both: FSDP splits over
# ``data`` only), and each LM's whole
PARAMS = {"gemma3-1b": (250_182_144, 4.00e9), "starcoder2-7b": (1_850_886_144, 29.6e9),
          "yi-9b": (139_542_528, 35.3e9), "granite-moe-1b-a400m": (349_442_048, 5.54e9),
          "mixtral-8x7b": (734_969_856, 186.8e9)}


@pytest.fixture(scope="module")
def records():
    return {(a, s, m): dryrun.count_cell(a, s, dryrun.H100_BYTES, "test", mesh_name=m)
            for m in MESHES for a, s in LM_CELLS}


def _mesh(name):
    return make_production_mesh(multi_pod=name == "multi", device="meta")


def _spec(specs, path):
    return specs["layers"][path[7:]] if path.startswith("layers/") else specs[path]


def plan_bytes(arch: str, shape_name: str, mesh_name: str) -> dict:
    """The plan's collective bytes a device, by kind (c: the compute
    dtype's 2 bytes; t: a microbatch's or a call's tokens a replica):

    * train, each of n microbatches: all-gather: every FSDP weight's model
      block (its ``data`` split gathered), the layers' twice (the forward
      and the remat recompute), plus where the heads split whole but the
      kv heads do not the kv columns a position reads (k and v, twice), or
      where the heads do not split the whole k and v (twice);
      reduce-scatter: the gathers' backward, each position's block;
      all-to-all (query rows split): q there and o back, twice, and their
      backward, ``6 t H hd / m c`` a layer; all-reduce: the lookup's ``t d
      c``, a layer's ``5 t d c`` (Megatron's f backward in attention and
      MLP, g forward in both, the attention's again in the recompute: the
      checkpoint stops its recompute after the last saved tensor, before
      the MLP's g) and an MoE layer's gates ``t k c`` (f's backward), the
      loss's f backward ``t d c`` and its maximum, sum of exponentials and
      gold logit (f32, each twice: the chunk's recompute).  Once a step:
      each leaf's f32 block all-reduced over the data axes it does not
      split over, the loss's mean and the clip's two squared norms.
    * prefill: the FSDP gathers once; the cache's all-to-all (k and v: ``t
      KV hd / m c`` each a layer); the kv columns read or the rows plan's
      transfers, once; all-reduce: the lookup, and two a layer.
    * decode: the FSDP gathers; q, k and v all-gathered every layer;
      all-reduce: the lookup, and a layer's maximum and sum (f32, ``t H``
      each), output (``t H hd c``), and two ``t d c``; an MoE group that
      spans the replicas gathered (``T d c``) and reduced whole.
    """
    cfg = REGISTRY[arch].make_config()
    shape = next(s for s in REGISTRY[arch].shapes if s.name == shape_name)
    mesh = _mesh(mesh_name)
    m, dp, c = rules.model_size(mesh), mesh.dp, 2
    L, d, H, KV, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = shape.dims["batch"], shape.dims["seq"]
    specs, shapes = rules.lm_param_specs(cfg, mesh), tm._shapes(cfg)

    def size(path, gathered=False):
        spec = _spec(specs, path)
        if gathered:
            spec = tuple(None if e == "data" else e for e in spec)
        return math.prod(rules.local_shape(shapes[path], spec, mesh))

    fsdp = [p for p in shapes if "data" in _spec(specs, p)]
    layer_gather = sum(size(p, True) for p in fsdp if p.startswith("layers/")) // L * c
    layer_scatter = sum(size(p) for p in fsdp if p.startswith("layers/")) // L * c
    top_gather = sum(size(p, True) for p in fsdp if not p.startswith("layers/")) * c
    top_scatter = sum(size(p) for p in fsdp if not p.startswith("layers/")) * c
    heads, kv_whole = rules.heads_split(cfg, mesh), rules.kv_split(cfg, mesh)
    k0, k1 = rules.kv_heads_read(cfg, rules.position_heads(cfg, mesh, 0)) if heads else (0, 0)
    read = 0 if kv_whole or not heads else (k1 - k0) * hd        # kv columns a position reads
    out = dict.fromkeys(collectives.KINDS, 0)
    if shape.kind == "train":
        n = min(cfg.micro_batches, max(B // dp, 1))
        t = B // dp // n * S
        out["all-gather"] = top_gather + L * 2 * (layer_gather + 2 * read * t * c)
        out["reduce-scatter"] = top_scatter + L * (layer_scatter + (2 * t * KV * hd // m * c
                                                                     if read else 0))
        if not heads:
            out["all-gather"] += L * 2 * 2 * t * KV * hd * c
            out["reduce-scatter"] += L * 2 * t * KV * hd // m * c
            out["all-to-all"] = L * 6 * t * H * hd // m * c
        moe = t * cfg.top_k * c if cfg.is_moe else 0
        out["all-reduce"] = 2 * t * d * c + L * (5 * t * d * c + moe) + 6 * t * 4
        out = {k: n * v for k, v in out.items()}
        dp_axes = rules.dp_axes(mesh)
        reduced = sum(size(p) * 4 for p in shapes if any(
            a not in {x for e in _spec(specs, p) for x in rules.entry_axes(e)}
            for a in dp_axes))
        out["all-reduce"] += reduced + 4 + 2 * 4
    elif shape.kind == "prefill":
        t = B // dp * S
        out["all-gather"] = top_gather + L * (layer_gather + 2 * read * t * c)
        out["all-to-all"] = L * 2 * t * KV * hd // m * c
        if not heads:
            out["all-gather"] += L * 2 * t * KV * hd * c
            out["all-to-all"] += L * 2 * t * H * hd // m * c
        out["all-reduce"] = t * d * c + L * 2 * t * d * c
    else:
        t = B // dp if B % dp == 0 else B
        out["all-gather"] = top_gather + L * (layer_gather + t * H * hd * c + 2 * t * KV * hd * c)
        out["all-reduce"] = t * d * c + L * (2 * t * H * 4 + t * H * hd * c + 2 * t * d * c)
        T = B
        if cfg.is_moe and t % min(cfg.moe_group_size, T):
            out["all-gather"] += L * T * d * c
            out["all-reduce"] += L * (T - t) * d * c
    return out


def test_every_lm_cell_counts_a_device_of_both_meshes(records):
    """17 cells on each mesh, ``ok``, a device's figures; every device's peak
    fits one card."""
    assert len(LM_CELLS) == 17 and len(records) == 34
    for (arch, shape, mesh), rec in records.items():
        assert rec["ok"], (arch, shape, mesh, rec.get("error"))
        assert rec["n_devices"] == MESHES[mesh] and rec["mesh"] == mesh
        assert rec["positions_counted"] == 1 and rec["fits_one_card"]
    mixtral = records[("mixtral-8x7b", "train_4k", "single")]
    assert REGISTRY["mixtral-8x7b"].make_config().n_layers == 32
    assert mixtral["sum"]["flops"] == 256 * mixtral["flops"]


def test_a_device_holds_its_blocks_of_params_state_inputs_and_cache(records):
    """Per-device parameter bytes equal the table (f32 in a train cell, bf16
    serving), adamw's state twice them and its step count, the batch's
    rows over the data replicas, and the cache's block under
    ``lm_cache_spec`` (gemma3-1b's decode_32k 436,207,616 B of its
    111,669,149,696 on one pod, its long_500k 54,525,952 of 13,958,643,712)."""
    for (arch, shape_name, mesh_name), rec in records.items():
        cfg = REGISTRY[arch].make_config()
        shape = next(s for s in REGISTRY[arch].shapes if s.name == shape_name)
        mesh = _mesh(mesh_name)
        local, whole = PARAMS[arch]
        assert abs(cfg.n_params() * 4 - whole) < 0.005 * whole
        assert rules.local_bytes(tm.init(torch.Generator().manual_seed(0), cfg,
                                         device="meta"),
                                 rules.lm_param_specs(cfg, mesh), mesh) == local
        B, S = shape.dims["batch"], shape.dims["seq"]
        if shape.kind == "train":
            assert rec["param_bytes"] == local and rec["opt_state_bytes"] == 2 * local + 4
            rows = B // mesh.dp
            assert rec["input_bytes"] == 2 * rows * S * 4 + 4
            assert rows * S * 8 == {"single": 524_288, "multi": 262_144}[mesh_name]
            continue
        assert rec["param_bytes"] == local // 2 and rec["opt_state_bytes"] == 0
        spec = rules.lm_cache_spec(mesh, B)
        want = math.prod(rules.local_shape((cfg.n_layers, 2, B, S, cfg.n_kv_heads, cfg.hd),
                                           spec, mesh)) * 2
        assert rec["cache_bytes"] == want
        rows = B // mesh.dp if B % mesh.dp == 0 else B
        assert rec["input_bytes"] == rows * (S if shape.kind == "prefill" else 1) * 4 + \
            (4 if shape.kind == "decode" else 0)
    gemma = {k[1:]: r["cache_bytes"] for k, r in records.items() if k[0] == "gemma3-1b"
             and "cache_bytes" in r}
    assert gemma[("decode_32k", "single")] == 436_207_616
    assert gemma[("decode_32k", "multi")] == 218_103_808
    assert gemma[("long_500k", "single")] == 54_525_952
    assert gemma[("long_500k", "multi")] == 27_262_976


def test_collective_bytes_are_the_plans(records):
    """Each record's collective bytes, kind by kind, equal ``plan_bytes``."""
    for (arch, shape, mesh), rec in records.items():
        got = {k: v["total_bytes"] for k, v in rec["collective_bytes"].items()}
        assert got == plan_bytes(arch, shape, mesh), (arch, shape, mesh)
