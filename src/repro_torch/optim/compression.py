"""Int8 gradient compression with error feedback, for the data-parallel
gradient reduction.  Port of ``repro.optim.compression``.

Protocol, at each position of the data axis:

    q, scale = int8 grid of (g + error) at one scale shared by the axis
    g_hat = (sum of the positions' q, in int32) * scale / n    (the mean)
    error = (g + error) - q * scale                            (carried over)

One process drives the port's mesh (``launch.mesh``), so
``compressed_psum`` takes the tensor and the error of every position of
the axis at once, as lists, where the reference's runs inside
``shard_map`` once a position: the scale is the maximum over the
positions (the reference's ``pmax``), and the int8 grids are summed in
int32 on the first position's device, in position order (the reference's
``psum``, exact; its float32 value too, for up to 132,104 positions).  The tensor-parallel
reductions stay exact; only this one is compressed.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.sharding import collectives


def int8_compress(x: torch.Tensor):
    """Per-tensor symmetric quantization: ``(int8 values, float32 scale)``,
    ``scale = max(max|x|, 1e-12) / 127``."""
    amax = x.abs().max().to(torch.float32)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _quantize(x, scale), scale


def _quantize(x, scale):
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(xs: list, errors: list, positions=None) -> tuple[list, list]:
    """Error-feedback compressed mean over the positions of a data axis:
    ``xs[i]`` and ``errors[i]`` are position ``i``'s tensor and error (one
    shape and type, each on its position's device).  Returns ``(outs,
    new_errors)``: position ``i``'s copy of the dequantized mean, on its
    device, and its new error.  ``outs[i] + new_errors[i]`` is ``xs[i] +
    errors[i]`` plus the other positions' grid points, so with one position
    it is the input, within rounding.  ``positions``: the mesh positions
    of ``xs`` (``launch.mesh.Mesh.groups``), to which the wire's traffic is
    reported (``sharding.collectives``): at each, an all-reduce of the
    scale (4 bytes, the reference's ``pmax``) and one of the int8 grid (a
    byte an element; the reference's HLO sums it as int32)."""
    if not xs or len(xs) != len(errors):
        raise ValueError(f"{len(xs)} tensors and {len(errors)} errors")
    if positions is not None and len(xs) > 1:
        collectives.report("all-reduce", positions, 4)
        collectives.report("all-reduce", positions, xs[0].numel())
    first = xs[0].device
    corr = [x + e for x, e in zip(xs, errors)]
    # one scale for the axis (the reference's pmax), so the grids add exactly
    amax = functools.reduce(torch.maximum, (c.abs().max().to(torch.float32).to(first)
                                             for c in corr))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    qs = [_quantize(c, scale.to(c.device)) for c in corr]
    new_errors = [c - int8_decompress(q, scale.to(c.device), c.dtype) for c, q in zip(corr, qs)]
    q_sum = functools.reduce(torch.add, (q.to(device=first, dtype=torch.int32) for q in qs))
    mean = (q_sum.to(torch.float32) * scale / float(len(xs))).to(xs[0].dtype)
    return [mean.to(x.device) for x in xs], new_errors
