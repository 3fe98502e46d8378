"""gc_share: the share of the window spent in the collector, any
generation, inside the ticks, the answers or elsewhere, in %."""

from hqbench.metrics._since import since


def read(view):
    rows = since(view)
    if not rows:
        return None
    ms = sum(s["gc_tick"] + s["gc_answers"] + s["gc_other"] for s in rows)
    return 100.0 * ms / (view.window_s * 1e3)
