"""solve_ms: the model's solve (`solve_host_prep` + `solve_dispatch` +
`device_sync`), mean over the ticks that solved."""

from hqbench.metrics._util import phase_mean


def read(view):
    return phase_mean(view, "solve_host_prep", "solve_dispatch",
                      "device_sync")
