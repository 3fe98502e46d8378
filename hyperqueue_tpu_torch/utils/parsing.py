"""Shared value parsers used by both the CLI and TOML job files.

Reference: crates/hyperqueue/src/client/commands/submit/command.rs
parse_crash_limit — defs.rs deserialize_crash_limit reuses the same parser
so the CLI and job-file encodings can never drift.
"""

from __future__ import annotations

# Wire encoding (gateway.rs CrashLimit): positive = MaxCrashes,
# 0 = Unlimited, -1 = NeverRestart (fails on ANY worker loss while
# running, even clean stops — reactor.rs:166).
CRASH_LIMIT_NEVER_RESTART = -1
CRASH_LIMIT_UNLIMITED = 0


def parse_crash_limit(value, exc_type: type[Exception] = ValueError) -> int:
    """Positive integer, ``never-restart`` (-1) or ``unlimited`` (0)."""
    if isinstance(value, str):
        text = value.strip()
        if text == "never-restart":
            return CRASH_LIMIT_NEVER_RESTART
        if text == "unlimited":
            return CRASH_LIMIT_UNLIMITED
        try:
            value = int(text)
        except ValueError:
            raise exc_type(
                f"crash limit must be a positive integer, 'never-restart' "
                f"or 'unlimited', got {text!r}"
            ) from None
    limit = int(value)
    if limit == 0:
        # reference command.rs:1076 rejects 0 the same way
        raise exc_type(
            "crash limit cannot be 0; use 'never-restart' or 'unlimited' "
            "instead"
        )
    if limit < 0:
        raise exc_type(
            f"crash limit must be a positive integer, 'never-restart' or "
            f"'unlimited', got {value!r}"
        )
    return limit
