"""tasks_started_per_s: every task a worker started in the window, over
the window's seconds."""


def read(view):
    return view.cell.window_started / view.window_s
