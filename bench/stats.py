"""Order statistics of the window's samples."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of every value
    given, no sample dropped; an infinite value (a request that never came
    back) stays infinite. NaN for no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]
