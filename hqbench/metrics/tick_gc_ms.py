"""tick_gc_ms: garbage collection inside the ticks (gc.callbacks), mean a
tick."""

from hqbench.metrics._util import mean


def read(view):
    return mean(t.gc_ms for t in view.ticks)
