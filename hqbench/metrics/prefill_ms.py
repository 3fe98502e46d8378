"""prefill_ms: the tick's prefill phase (prefill, displacement and
rebalance retracts), mean a tick."""

from hqbench.metrics._util import phase_mean


def read(view):
    return phase_mean(view, "prefill")
