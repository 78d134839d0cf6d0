"""Partition rules of the port (``rules``) and the one-process mesh's
collectives (``collectives``).  Port of ``repro.sharding``.

The reference's ``shard_map`` and ``shard_map_norep`` have no
counterpart: the port's mesh is driven from one process, and each
sharded module (``serving.sharded``, ``embedding.sharded``,
``models.recsys.fwfm.rank_items_mp``, ``launch.train``'s data-parallel
step) loops over its positions itself, each position's work on its own
device, and reduces across positions through ``collectives``."""
from repro_torch.sharding import collectives  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    corpus_cache_specs,
    corpus_slab_axis,
    corpus_slab_spec,
    dp_axes,
    entry_axes,
    gnn_param_specs,
    lm_batch_spec,
    lm_cache_spec,
    lm_param_specs,
    local_block,
    local_bytes,
    local_shape,
    model_size,
    opt_state_specs,
    recsys_param_specs,
)
