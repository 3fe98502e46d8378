"""tick_ms_mean: the window's milliseconds over the ticks run in it, the
time the workers wait between decisions."""


def read(view):
    if not view.ticks:
        return None
    return view.window_s * 1e3 / len(view.ticks)
