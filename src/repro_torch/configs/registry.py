"""Architecture registry of the port.  Port of ``repro.configs.registry``,
holding the entries the port can build: the recsys family ``dplr-fwfm``,
``wide-deep``, ``autoint``, ``bst`` and ``mind`` (all train through
``launch.train``; all rank per call, ``dplr-fwfm`` also through the corpus
engine); the lm family, dense ``gemma3-1b``, ``starcoder2-7b`` and
``yi-9b`` and mixture-of-experts ``granite-moe-1b-a400m`` and
``mixtral-8x7b`` (train through ``launch.train``, serve through
``model.prefill`` and ``decode_step``); and the gnn family ``pna`` (trains through
``examples.gnn_train``).  The JAX package registers each architecture in
its config module; here the entries are made below, so that the config
modules stay free of the registry (their shapes are ``spec.ShapeSpec``)."""
from __future__ import annotations

from repro_torch.configs import (
    autoint,
    bst,
    dplr_fwfm,
    gemma3_1b,
    granite_moe_1b_a400m,
    mind,
    mixtral_8x7b,
    pna,
    starcoder2_7b,
    wide_deep,
    yi_9b,
)
from repro_torch.configs.spec import ArchSpec, ShapeSpec

__all__ = ["REGISTRY", "ArchSpec", "ShapeSpec", "get", "lm_shapes", "register"]


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    assert spec.name not in REGISTRY, spec.name
    REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    return REGISTRY[name]


def lm_shapes(long_ctx_skip: str | None) -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
        ShapeSpec("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        ShapeSpec("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        ShapeSpec("long_500k", "decode", {"seq": 524288, "batch": 1},
                  skip=long_ctx_skip),
    )


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "rank", {"n_queries": 1, "n_items": 512}),
    ShapeSpec("serve_bulk", "pointwise", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "rank", {"n_queries": 1, "n_items": 1_000_000}),
)

register(ArchSpec(
    name="gemma3-1b", family="lm",
    make_config=gemma3_1b.make_config, make_smoke=gemma3_1b.make_smoke,
    shapes=lm_shapes(None),
    notes="dense; trains through the plain attention, serves through kernel 7",
))

register(ArchSpec(
    name="starcoder2-7b", family="lm",
    make_config=starcoder2_7b.make_config, make_smoke=starcoder2_7b.make_smoke,
    shapes=lm_shapes(long_ctx_skip="pure full-attention arch (no sub-quadratic "
                                   "mechanism) — skip per assignment note"),
))

register(ArchSpec(
    name="yi-9b", family="lm",
    make_config=yi_9b.make_config, make_smoke=yi_9b.make_smoke,
    shapes=lm_shapes(long_ctx_skip="pure full-attention arch — skip per "
                                   "assignment note"),
))

register(ArchSpec(
    name="granite-moe-1b-a400m", family="lm",
    make_config=granite_moe_1b_a400m.make_config,
    make_smoke=granite_moe_1b_a400m.make_smoke,
    shapes=lm_shapes(long_ctx_skip="pure full-attention arch — skip per "
                                   "assignment note"),
))

register(ArchSpec(
    name="mixtral-8x7b", family="lm",
    make_config=mixtral_8x7b.make_config, make_smoke=mixtral_8x7b.make_smoke,
    shapes=lm_shapes(long_ctx_skip=None),
))

register(ArchSpec(
    name="pna", family="gnn",
    make_config=pna.make_config, make_smoke=pna.make_smoke,
    shapes=pna.SHAPES,
))

register(ArchSpec(
    name="dplr-fwfm", family="recsys",
    make_config=dplr_fwfm.make_config, make_smoke=dplr_fwfm.make_smoke,
    shapes=RECSYS_SHAPES,
    notes="the paper's own model; 'fwfm'/'fm' interactions are the baselines",
))

for _name, _module in (("wide-deep", wide_deep), ("autoint", autoint), ("bst", bst),
                       ("mind", mind)):
    register(ArchSpec(name=_name, family="recsys", make_config=_module.make_config,
                      make_smoke=_module.make_smoke, shapes=RECSYS_SHAPES))
