"""PyTorch and CUDA port of the DPLR-FwFM serving system (``repro``).

Module paths mirror the JAX package: ``repro_torch.serving.corpus`` ports
``repro.serving.corpus``.  The package imports PyTorch and numpy, never JAX
or ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see ``repro_torch.device``.
"""
