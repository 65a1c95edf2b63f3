"""The statistics the metrics and the bounds use."""

from __future__ import annotations

import statistics


def rate(items: list, seconds: float, per: float = 1e6) -> float:
    """Units of work (`rays`) of every item over the measured seconds."""
    return sum(i["rays"] for i in items) / seconds / per


def p95(values: list) -> float:
    """The 95th percentile of all values (linear between order
    statistics, `statistics.quantiles`' inclusive method); a lone value
    is its own."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def mean(values: list) -> float:
    return sum(values) / len(values)
