"""k1_roofline: the least time the chip could take for K1's launches in
the window (bytes and operations counted at each launch's live shapes,
hqbench/roofline/k1.py, against the H100's published peaks), over their
device time, in %."""

from hqbench.roofline import k1


def read(view):
    trace = view.trace
    if not trace or not trace.get("k1"):
        return None
    n_r = trace["n_resources"]
    least = sum(k1.least_ms(n_b, n_v, n_w, n_r, n_m)
                for (n_b, n_v, n_w, n_m), _t in trace["k1"])
    spent = sum(t for _s, t in trace["k1"])
    if spent <= 0:
        return None
    return 100.0 * least / spent
