"""assemble_ms: batches and the solve's inputs (the tick's `batches` and
`assemble` phases), mean over the ticks that solved."""

from hqbench.metrics._util import phase_mean


def read(view):
    return phase_mean(view, "batches", "assemble")
