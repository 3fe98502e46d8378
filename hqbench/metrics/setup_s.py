"""setup_s: the process's start to the first timed tick (s): state,
the model and its kernels, the first ticks the traffic needs."""


def read(view):
    return view.setup_s
