"""Helpers the metric readers share."""

from __future__ import annotations


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def phase_mean(view, *names):
    """Mean over the window's ticks of the sum of these tick phases (ms);
    None where no tick recorded any of them."""
    ticks = [t for t in view.ticks if any(n in t.phases for n in names)]
    if not ticks:
        return None
    return mean(sum(t.phases.get(n, 0.0) for n in names) for t in ticks)
