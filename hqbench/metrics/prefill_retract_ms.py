"""prefill_retract_ms: the tick's `prefill_retract` sub-phase (the
displacement victim lists, displacement and rebalance retracts), mean a
tick."""

from hqbench.metrics._util import phase_mean


def read(view):
    return phase_mean(view, "prefill_retract")
