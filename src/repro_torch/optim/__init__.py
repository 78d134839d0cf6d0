"""Optimizers, schedules, gradient accumulation and the int8 gradient
compression.  Port of ``repro.optim``, with the same exports (and
``value_and_grad``, the port's ``jax.value_and_grad``)."""
from repro_torch.optim.accumulate import gradient_accumulation, value_and_grad  # noqa: F401
from repro_torch.optim.compression import int8_compress, int8_decompress  # noqa: F401
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adagrad,
    adamw,
    apply_weight_decay,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedules import constant, warmup_cosine  # noqa: F401
