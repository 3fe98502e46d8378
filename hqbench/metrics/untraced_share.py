"""untraced_share: the share of the window in none of the program's
spans (the ticks, the answers, the collector's passes outside both), in
%: the benchmark's own bookkeeping and the loop's sleeps."""

from hqbench.metrics._since import answers_on, since


def read(view):
    if not answers_on(view):
        return None
    ticks_ms = sum(t.phases.get("total", 0.0) for t in view.ticks)
    rest_ms = sum(s.get("answers", 0.0) + s["gc_other"] for s in since(view))
    return 100.0 * (1.0 - (ticks_ms + rest_ms) / (view.window_s * 1e3))
