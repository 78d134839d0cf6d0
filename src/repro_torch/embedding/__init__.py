from repro_torch.embedding.bag import (  # noqa: F401
    embedding_bag,
    init_embedding_table,
    lookup_field_embeddings,
)
from repro_torch.embedding.sharded import sharded_lookup_field_embeddings  # noqa: F401
