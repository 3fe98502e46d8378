"""What K1 (the cut-scan kernel) needs at a launch's shapes, whatever
implements it, and the least time the H100 could take for it.

Shapes: B batches, V variants, W workers, R resources, M distinct request
masks (rows of the visit classes). Each input is read once and each
output written once, all int32:

  read:  free (W, R), nt_free (W), lifetime (W), needs (B, V, R),
         sizes (B), min_time (B, V), class_m (M, W), order_ids (B, V)
  write: counts (B, V, W), free (W, R), nt_free (W)

Operations: the scan visits every batch at least once; per batch and
worker, a capacity is the least over R resources of free // need (R
divisions, R minima), clamped by the slots, the lifetime and the remaining
size (3), then a prefix sum and a take (2), and R updates of free and one
of the slots: 4 R + 6 integer operations. Later variants of a batch run
only while tasks remain, which the shapes do not say, so they are not
counted.

Peaks: NVIDIA's data sheet for the H100 SXM, as the on-chip guide gives
them: 3.35e12 B/s of HBM and 67e12 32-bit operations a second (the float32
rate outside the tensor cores, taken for the integer ALU too).
"""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
WORD = 4


def bytes_moved(n_b, n_v, n_w, n_r, n_m):
    read = (n_w * n_r + 2 * n_w + n_b * n_v * n_r + n_b + 2 * n_b * n_v
            + n_m * n_w)
    write = n_b * n_v * n_w + n_w * n_r + n_w
    return WORD * (read + write)


def operations(n_b, n_v, n_w, n_r, n_m):
    return n_b * n_w * (4 * n_r + 6)


def least_ms(n_b, n_v, n_w, n_r, n_m):
    """The larger of the bytes' and the operations' time, in ms."""
    return 1e3 * max(bytes_moved(n_b, n_v, n_w, n_r, n_m) / HBM_BYTES_PER_S,
                     operations(n_b, n_v, n_w, n_r, n_m) / OPS_PER_S)
