"""#HQ directive parsing from submitted shell scripts.

Reference: crates/hyperqueue/src/client/commands/submit/directives.rs +
docs/jobs/directives.md — lines starting with `#HQ ` in the leading comment
block of a submitted script contribute submit arguments; explicit CLI
arguments take precedence.
"""

from __future__ import annotations

import shlex
from pathlib import Path

DIRECTIVE_PREFIX = "#HQ "
MAX_SCAN_BYTES = 32 * 1024


def parse_directives(path: str | Path) -> list[str]:
    """Extract tokens from #HQ lines in the leading comment block."""
    try:
        with open(path, "r", errors="replace") as f:
            text = f.read(MAX_SCAN_BYTES)
    except OSError:
        return []
    return parse_directives_text(text)


def parse_directives_text(text: str) -> list[str]:
    """#HQ tokens from script text (used for `--directives stdin`, where the
    script arrives on standard input — reference DirectivesMode::Stdin)."""
    tokens: list[str] = []
    for i, line in enumerate(text[:MAX_SCAN_BYTES].splitlines()):
        stripped = line.strip()
        if i == 0 and stripped.startswith("#!"):
            continue
        if not stripped:
            continue
        if not stripped.startswith("#"):
            break  # directives live only in the leading comment block
        if stripped.startswith(DIRECTIVE_PREFIX.rstrip()) and (
            stripped.startswith(DIRECTIVE_PREFIX) or stripped == "#HQ"
        ):
            tokens.extend(shlex.split(stripped[len(DIRECTIVE_PREFIX):]))
    return tokens


def should_parse(path: str, mode: str) -> bool:
    if mode == "off":
        return False
    if mode == "file":
        return True
    # auto: only .sh files that exist
    return path.endswith(".sh") and Path(path).exists()
