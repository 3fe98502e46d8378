"""Build and load the package's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` has a plain C interface and is compiled
with nvcc for Hopper (sm_90a) into a shared library, loaded with ctypes. The
build runs at first use, from the package's own sources only, into
`_build/` beside the package (ignored by git): the library's file name
carries a hash of the source, of every header of `csrc/` that it includes
(directly or through another header) and of the compiler flags, so an
edited source or header builds anew, and a file lock lets concurrent
processes share one build.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# `#include "name"` lines: the headers a source takes from csrc/
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"',
                      re.MULTILINE)

# name -> (ctypes library, build record); one load per process
_LOADED: dict[str, tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    """The nvcc of the CUDA toolkit PyTorch itself would build with."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH)"
    )


def source_digest(name: str) -> str:
    """16 hex digits of a hash over `csrc/<name>.cu`, the `csrc/` headers
    it includes, directly or through another header, and NVCC_FLAGS."""
    digest = hashlib.sha256()
    seen: set[Path] = set()

    def add(path: Path) -> None:
        seen.add(path)
        text = path.read_bytes()
        digest.update(text)
        for include in _INCLUDE.findall(text):
            header = CSRC_DIR / include.decode()
            if header not in seen and header.is_file():
                add(header)

    add(CSRC_DIR / f"{name}.cu")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def load_library(name: str) -> tuple[ctypes.CDLL, dict]:
    """Compile `csrc/<name>.cu` if needed and load it.

    Returns (library, record); record holds the library path, whether this
    call compiled it, the seconds the compile took and nvcc's resource
    usage report (registers, shared memory, spills). Raises when the
    compiler is missing or refuses the source.
    """
    loaded = _LOADED.get(name)
    if loaded is not None:
        return loaded
    source = CSRC_DIR / f"{name}.cu"
    digest = source_digest(name)
    BUILD_DIR.mkdir(exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = BUILD_DIR / f"lib{name}-{digest}.log"
    record = {"path": str(lib_path), "compiled": False, "seconds": 0.0}
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), str(source)],
                capture_output=True, text=True, timeout=600,
            )
            record["seconds"] = time.perf_counter() - t0
            log_path.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                tmp_path.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {source.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp_path, lib_path)
            record["compiled"] = True
    record["ptxas"] = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, record)
    return lib, record
