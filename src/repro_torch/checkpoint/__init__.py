from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, list_checkpoints, restore_pytree, save_pytree,
)
