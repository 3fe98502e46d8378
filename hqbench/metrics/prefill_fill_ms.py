"""prefill_fill_ms: the tick's `prefill_fill` sub-phase (budgets,
reservations, the take-and-message loop), mean a tick."""

from hqbench.metrics._util import phase_mean


def read(view):
    return phase_mean(view, "prefill_fill")
