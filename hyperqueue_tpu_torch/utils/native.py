"""ctypes loader for the native host core (native/hqcore.cpp): the task
queue and its one-call map-take, the host scan and the nonzero pass.

The library is built with the host's C++ compiler at first use, from the
package's own source, into `_build/` beside the package (ignored by git):
its file name carries a hash of the source and the flags, so an edited
source builds anew, and a file lock lets concurrent processes share one
build. On a host without a C++ compiler every entry point here returns
None, make_task_queue returns the Python TaskQueue, and the caller solves
with the numpy twin (ops/assign.greedy_cut_scan_numpy): the Python and
native structures share their semantics, and the tests hold them equal.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "hqcore.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_tried = False


def load_native():
    """Returns the ctypes library, or None when it cannot be built or
    loaded."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    cxx = shutil.which("g++") or shutil.which("c++")
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libhqcore-{digest}.so"
    try:
        BUILD_DIR.mkdir(exist_ok=True)
        with open(BUILD_DIR / "hqcore.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                if cxx is None:
                    raise OSError("no C++ compiler on PATH")
                tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        [cxx, *CXX_FLAGS, "-o", str(tmp_path), str(SOURCE)],
                        capture_output=True, timeout=120, check=True,
                    )
                    os.replace(tmp_path, lib_path)
                finally:
                    tmp_path.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(lib_path))
        _set_prototypes(lib)
    except (OSError, AttributeError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired) as e:
        logger.debug("native host scan unavailable: %s", e)
        return None
    _lib = lib
    return _lib


def _set_prototypes(lib) -> None:
    lib.hq_queue_new.restype = ctypes.c_void_p
    lib.hq_queue_free.argtypes = [ctypes.c_void_p]
    lib.hq_queue_add.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
    ]
    lib.hq_queue_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.hq_queue_len.argtypes = [ctypes.c_void_p]
    lib.hq_queue_len.restype = ctypes.c_int64
    lib.hq_queue_priority_sizes.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.hq_queue_priority_sizes.restype = ctypes.c_int64
    lib.hq_queue_take.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.hq_queue_take.restype = ctypes.c_int64
    lib.hq_queue_all.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
    ]
    lib.hq_queue_all.restype = ctypes.c_int64
    lib.hq_map_take.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hq_map_take.restype = ctypes.c_int64
    lib.hq_cut_scan.argtypes = [
        ctypes.POINTER(ctypes.c_int64),   # free (W,R)
        ctypes.POINTER(ctypes.c_int64),   # total (W,R) or NULL
        ctypes.POINTER(ctypes.c_int64),   # nt (W)
        ctypes.POINTER(ctypes.c_int32),   # lifetime (W)
        ctypes.POINTER(ctypes.c_int64),   # needs (B,V,R)
        ctypes.POINTER(ctypes.c_int32),   # all_mask (B,V,R) or NULL
        ctypes.POINTER(ctypes.c_int64),   # sizes (B)
        ctypes.POINTER(ctypes.c_int32),   # min_time (B,V)
        ctypes.POINTER(ctypes.c_int32),   # class_m (M,W)
        ctypes.POINTER(ctypes.c_int32),   # order_ids (B,V)
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,                   # W R B V M
        ctypes.POINTER(ctypes.c_int32),   # counts out (B,V,W)
    ]
    lib.hq_cut_scan.restype = None
    lib.hq_nonzero.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.hq_nonzero.restype = ctypes.c_int64


def native_cut_scan(
    free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
    total=None, all_mask=None,
):
    """Native host solve with the numpy twin's exact semantics
    (ops/assign.greedy_cut_scan_numpy, without gang rows and policy mask);
    returns counts (B,V,W) int32 or None when the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    free = np.ascontiguousarray(free, dtype=np.int64)
    nt = np.ascontiguousarray(nt_free, dtype=np.int64)
    life = np.ascontiguousarray(lifetime, dtype=np.int32)
    needs = np.ascontiguousarray(needs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    mt = np.ascontiguousarray(min_time, dtype=np.int32)
    cm = np.ascontiguousarray(class_m, dtype=np.int32)
    oi = np.ascontiguousarray(order_ids, dtype=np.int32)
    n_w, n_r = free.shape
    n_b, n_v, _ = needs.shape
    counts = np.zeros((n_b, n_v, n_w), dtype=np.int32)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    total_p = None
    amask_p = None
    if all_mask is not None:
        if total is None:
            # the numpy twin reads total[:, all_r] and would raise;
            # silently substituting free would grant ALL requests on
            # partially-busy workers
            raise ValueError("all_mask requires total")
        total = np.ascontiguousarray(total, dtype=np.int64)
        amask = np.ascontiguousarray(all_mask, dtype=np.int32)
        total_p = ptr(total, ctypes.c_int64)
        amask_p = ptr(amask, ctypes.c_int32)
    lib.hq_cut_scan(
        ptr(free, ctypes.c_int64),
        total_p,
        ptr(nt, ctypes.c_int64),
        ptr(life, ctypes.c_int32),
        ptr(needs, ctypes.c_int64),
        amask_p,
        ptr(sizes, ctypes.c_int64),
        ptr(mt, ctypes.c_int32),
        ptr(cm, ctypes.c_int32),
        ptr(oi, ctypes.c_int32),
        n_w, n_r, n_b, n_v, cm.shape[0],
        ptr(counts, ctypes.c_int32),
    )
    return counts


def native_nonzero(counts):
    """(flat_indices, values) of the nonzero cells of a C-contiguous int32
    ndarray in row-major order, or None when the library is unavailable
    (or the array is not C-contiguous int32). One C pass instead of
    numpy's nonzero plus a fancy-index gather."""
    lib = load_native()
    if lib is None:
        return None
    if counts.dtype != np.int32 or not counts.flags.c_contiguous:
        return None  # a copy here would eat the win; caller uses np.nonzero
    n = counts.size
    # nonzero cells are bounded by the (batch, worker) pairs the water-fill
    # can touch; start modest and retry on overflow
    capacity = min(n, 65536)
    while True:
        flat = np.empty(capacity, dtype=np.int64)
        vals = np.empty(capacity, dtype=np.int64)
        got = lib.hq_nonzero(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            capacity,
        )
        if got < capacity or capacity >= n:
            return flat[:got], vals[:got]
        capacity = n


class NativeTaskQueue:
    """Same interface as scheduler.queues.TaskQueue, backed by C++."""

    __slots__ = ("_lib", "_handle")

    MAX_LEVELS = 4096

    def __init__(self, lib):
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.hq_queue_new())

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.hq_queue_free(self._handle)
            self._handle = None

    def __len__(self) -> int:
        return self._lib.hq_queue_len(self._handle)

    def add(self, priority, task_id: int) -> None:
        self._lib.hq_queue_add(self._handle, priority[0], priority[1], task_id)

    def remove(self, task_id: int) -> None:
        self._lib.hq_queue_remove(self._handle, task_id)

    def priority_sizes(self):
        n = self.MAX_LEVELS
        pu = (ctypes.c_int64 * n)()
        ps = (ctypes.c_int64 * n)()
        counts = (ctypes.c_int64 * n)()
        got = self._lib.hq_queue_priority_sizes(self._handle, pu, ps, counts, n)
        return [((pu[i], ps[i]), counts[i]) for i in range(got)]

    def take(self, priority, count: int):
        out = (ctypes.c_uint64 * count)()
        got = self._lib.hq_queue_take(
            self._handle, priority[0], priority[1], count, out
        )
        return [out[i] for i in range(got)]

    def all_tasks(self):
        n = len(self)
        out = (ctypes.c_uint64 * max(n, 1))()
        got = self._lib.hq_queue_all(self._handle, out, n)
        return [out[i] for i in range(got)]


def make_task_queue():
    """The native queue where the library is built, else the Python
    TaskQueue."""
    lib = load_native()
    if lib is not None:
        return NativeTaskQueue(lib)
    from hyperqueue_tpu_torch.scheduler.queues import TaskQueue

    return TaskQueue()
