"""gc_full_ms: the collector's passes over its older generations, mean a
pass in the window, on the program's record; nothing where no such pass
fell in the window.

A pass over the older generations is one of generation 1 or 2: every pass
that is not of the youngest generation alone. At the thresholds the
server sets (100,000, 50, 25) a gen-1 pass comes every 50 gen-0 passes,
some 15-20 s apart in these cells, and takes most of a second; a gen-2
pass comes 25 gen-1 passes later still, minutes apart."""


def read(view):
    ms = n = 0
    for t in view.ticks:
        if "since_n" in t.phases:
            since_ms, since_n = t.phases["since_ms"], t.phases["since_n"]
            ms += since_ms["gc_gen1"] + since_ms["gc_gen2"]
            n += since_n["gc_gen1"] + since_n["gc_gen2"]
    return ms / n if n else None
