"""Partition rules of the port (``rules``).  Port of ``repro.sharding``.

The reference's ``shard_map`` and ``shard_map_norep`` have no
counterpart: the port's mesh is driven from one process, and each
sharded module (``serving.sharded``, ``models.recsys.fwfm.rank_items_mp``)
loops over its shards itself, each shard's work on its own device."""
from repro_torch.sharding.rules import (  # noqa: F401
    corpus_cache_specs,
    corpus_slab_axis,
    corpus_slab_spec,
    dp_axes,
    gnn_param_specs,
    lm_batch_spec,
    lm_cache_spec,
    lm_param_specs,
    model_size,
    opt_state_specs,
    recsys_param_specs,
)
