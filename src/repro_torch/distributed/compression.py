"""Gradient compression: int8-quantized all-reduce with error feedback
(port of ``repro.distributed.compression``).

For cross-pod gradient reduction the wire bytes dominate; int8 cuts them
4x against float32 (2x against bf16) at little cost in quality when the
residuals are fed back (1-bit Adam / PowerSGD lineage).

``compressed_psum`` over a mesh axis of ranks:
    q, scale = quantize(g + residual);  s = SUM(q);  g' = dequant(s)
    residual' = (g + residual) - dequant(q)        (local error feedback)
with the scale the MAX over the axis, so every rank dequantizes against the
same grid, and the int8 values summed exactly as int32.  The reference's
wire cost is N int8 and one float32 scale a leaf; gloo has no int8 SUM
here, so the values travel as int32 (:func:`wire_bytes` counts both).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed import collectives


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale), scale a float32 0-d
    tensor."""
    x = x.float()
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return _quantize(x, scale), scale


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor, mesh,
                    axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce of one gradient leaf with error feedback over
    ``axis``: (reduced, the mean in ``grad``'s dtype; new_residual, float32).
    """
    (reduced,), (resid,) = compressed_psum_tree([grad], [residual], mesh,
                                                axis)
    return reduced, resid


def compressed_psum_tree(grads: Any, residuals: Any, mesh, axis: str
                         ) -> Tuple[Any, Any]:
    """:func:`compressed_psum` of every leaf, the leaves' scales in one MAX
    and their int8 values in one int32 SUM over the axis."""
    flat_g, structure = tree_lib.flatten(grads)
    flat_r = tree_lib.leaves(residuals)
    comps = [g.float() + r for g, r in zip(flat_g, flat_r)]
    qs, scales, summed = quantized_sum(comps, mesh, axis)
    n = mesh.size(axis)
    reduced, resid, at = [], [], 0
    for g, c, q, s in zip(flat_g, comps, qs, scales):
        part = summed[at:at + q.numel()].view(q.shape)
        at += q.numel()
        reduced.append((part.float() * s / n).to(g.dtype))
        resid.append(c - q.float() * s)
    return (tree_lib.unflatten(structure, reduced),
            tree_lib.unflatten(structure, resid))


def quantized_sum(comps, mesh, axis: str):
    """The wire half of :func:`compressed_psum_tree` for float32 leaves
    ``comps``: each leaf's int8 values against the MAX over the axis of
    the ranks' scales (one collective for all the leaves), and their SUM
    over the axis as int32, the leaves flattened and concatenated (one
    collective).  Returns (q's, scales (n_leaves,), the sum)."""
    scales = torch.stack([quantize_int8(c)[1] for c in comps])
    collectives.all_reduce(scales, mesh, axis, collectives.MAX)
    qs = [_quantize(c, s) for c, s in zip(comps, scales)]
    summed = collectives.all_reduce_int32(
        torch.cat([q.reshape(-1) for q in qs]), mesh, axis)
    return qs, scales, summed


def init_residuals(params: Any) -> Any:
    return tree_lib.map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def wire_bytes(grads: Any) -> dict:
    """The bytes one rank sends a reduction of ``grads``: the reference's
    int8 values and a float32 scale a leaf, what gloo moves here (int32
    values), and float32's."""
    leaves = tree_lib.leaves(grads)
    n = sum(g.numel() for g in leaves)
    return {"int8": n + 4 * len(leaves), "int32_as_sent": 4 * n + 4 * len(
        leaves), "float32": 4 * n}
