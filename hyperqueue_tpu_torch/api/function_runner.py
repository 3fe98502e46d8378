"""Executes a cloudpickled (fn, args, kwargs) payload from stdin.

Reference: crates/pyhq/python/hyperqueue/task/function/__init__.py:39-149 —
the pickled function runs in a freshly spawned interpreter; a non-zero exit
code (with the traceback on stderr) marks the task failed.
"""

from __future__ import annotations

import sys


def main() -> int:
    import cloudpickle

    payload = sys.stdin.buffer.read()
    fn, args, kwargs = cloudpickle.loads(payload)
    result = fn(*args, **kwargs)
    if result is not None:
        print(repr(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
