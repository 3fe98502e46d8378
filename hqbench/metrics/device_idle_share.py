"""device_idle_share: 1 - device busy / the traced window, in %."""


def read(view):
    trace = view.trace
    if not trace or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
