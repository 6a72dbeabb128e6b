"""Statistics the readers share."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The smallest value with at least a share ``q`` of the values at or
    below it; None for no values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]
