"""Traffic loops, one module each, named by a mix's `loop`."""
