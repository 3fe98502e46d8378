"""harness_ms: the benchmark's worker model (the workers' answers through
the port's handlers), mean a tick."""

from hqbench.metrics._util import mean


def read(view):
    return mean(t.harness_ms for t in view.ticks)
