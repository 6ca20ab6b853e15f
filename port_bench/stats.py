"""The percentile the end-to-end tails use, over every sample given."""

from __future__ import annotations

import math


def percentile(values, q):
    """The nearest-rank q-th percentile of all `values` (inf sorts
    last: a request that never answered counts as missing any limit);
    None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]
