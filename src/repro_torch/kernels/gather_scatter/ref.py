"""Plain PyTorch versions of the GUPS-style row gather and scatter (paper
Fig 9; port of ``repro.kernels.gather_scatter.ref``): the CPU path, and
what the CUDA kernels are held to, bitwise.

Ids follow the JAX reference.  ``gather_ref`` is ``jnp.take(table, idx,
0)``: an id in ``[-R, 0)`` reads row ``id + R``, and an id outside
``[-R, R)`` gives a row of NaN.  ``scatter_ref`` is ``table.at[idx].set(src,
mode="drop")``: negative ids wrap the same way, an id out of range is
dropped, and where ids repeat the last write wins.  The plain scatter
picks each row's last draw explicitly (``scatter_reduce_`` with ``amax``)
and then copies unique rows, so it is deterministic on the card too.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wrap_ids(idx: torch.Tensor, R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, ok): int64 rows with negative ids wrapped (0 where the id is
    outside ``[-R, R)``), and whether each id is inside."""
    g = idx.long()
    ok = (g >= -R) & (g < R)
    return torch.where(g < 0, g + R, g).masked_fill(~ok, 0), ok


def gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, D), idx (N,) -> (N, D)."""
    g, ok = wrap_ids(idx, table.shape[0])
    return table.index_select(0, g).masked_fill(~ok[:, None], float("nan"))


def scatter_ref_(table: torch.Tensor, idx: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """Write src (N, D) into table (R, D) at idx (N,), in place; returns
    ``table``."""
    g, ok = wrap_ids(idx, table.shape[0])
    draw = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((table.shape[0],), -1, dtype=torch.long,
                        device=idx.device)
    winner.scatter_reduce_(0, g[ok], draw[ok], reduce="amax")
    keep = ok & (winner[g] == draw)
    return table.index_copy_(0, g[keep], src[keep])


def scatter_ref(table: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_ref_` on a copy of ``table``: a new table, as JAX
    returns one."""
    return scatter_ref_(table.clone(), idx, src)
