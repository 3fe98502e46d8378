"""mapping_ms: counts to task ids (the tick's `mapping` phase), mean over
the ticks that solved."""

from hqbench.metrics._util import phase_mean


def read(view):
    return phase_mean(view, "mapping")
