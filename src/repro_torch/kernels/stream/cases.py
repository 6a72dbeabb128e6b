"""The STREAM kernel's edge shapes, shared by the card tests and
``chip_smoke.py`` phase 19, so both hold the same edges of the persistent
grid (``kernels/csrc/stream.cu``) bitwise against the plain versions."""
from __future__ import annotations

from typing import Tuple


def edge_shapes(most: int) -> Tuple[Tuple[str, int, int], ...]:
    """``(what, rows, block_rows)`` of each edge; ``most`` is the largest
    grid the kernel launches on this card (SMs x resident blocks per SM,
    ``stream.plan``'s ``sms * blocks_per_sm`` for the op and dtype)."""
    return (("one tile of one row", 1, 1),
            ("fewer tiles than SMs", 64, 8),
            # 2 most + 1 tiles of 16 KiB (bfloat16) or 32 KiB (float32):
            # units past the grid's first two rounds, from the work queue
            ("tiles not a multiple of the grid", 64 * (2 * most + 1), 64),
            ("tiles larger than a unit", 2048, 1024),
            # 20 KiB float32 tiles (a 16 KiB unit and a quarter), 10 KiB
            # bfloat16 tiles (one a unit)
            ("tiles that end in part of a unit", 40 * 13, 40))
