"""Statistics the benchmark reports, written out so that their definition
is fixed here."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q ≤ 100) of all ``values``."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    return work / seconds

