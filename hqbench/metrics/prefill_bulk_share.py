"""prefill_bulk_share: of the tasks prefill sent in the window, the share
(%) that the lazy store made out of array chunks in the window's prefill
takes, a segment at a time (each tick's `since_n["prefill_bulk"]`),
against those taken from the base queues (`since_n["prefill_each"]`:
requeued, retracted or eager tasks). A program without these counts, or
a window in which nothing was prefilled, gives nothing to read."""

from hqbench.metrics._since import since


def read(view):
    counts = [n for n in since(view, "since_n") if "prefill_bulk" in n]
    bulk = sum(n["prefill_bulk"] for n in counts)
    total = bulk + sum(n["prefill_each"] for n in counts)
    return 100.0 * bulk / total if total else None
