"""Optimizers, schedules and gradient accumulation.  Port of
``repro.optim``, with the same exports except ``int8_compress`` and
``int8_decompress``: that compression is for the data-parallel gradient
all-reduce, which waits for the sharding item of ROADMAP queue 1."""
from repro_torch.optim.accumulate import gradient_accumulation, value_and_grad  # noqa: F401
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adagrad,
    adamw,
    apply_weight_decay,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedules import constant, warmup_cosine  # noqa: F401
