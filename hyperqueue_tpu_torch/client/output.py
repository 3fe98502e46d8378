"""Output formatting: CLI tables, JSON, quiet.

Reference: crates/hyperqueue/src/client/output/{cli,json,quiet}.rs — every
command renders through an Output backend selected by --output-mode so
scripts can rely on stable JSON while humans get tables.
"""

from __future__ import annotations

import json
import sys


class Output:
    def table(self, header: list[str], rows: list[list]) -> None:
        raise NotImplementedError

    def record(self, data: dict) -> None:
        raise NotImplementedError

    def message(self, text: str) -> None:
        raise NotImplementedError

    def value(self, value) -> None:
        raise NotImplementedError


class CliOutput(Output):
    def table(self, header, rows):
        widths = [len(h) for h in header]
        str_rows = [[str(c) for c in row] for row in rows]
        for row in str_rows:
            for i, cell in enumerate(row):
                widths[i] = max(widths[i], len(cell))
        line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(line)
        print(
            "|"
            + "|".join(f" {h.ljust(w)} " for h, w in zip(header, widths))
            + "|"
        )
        print(line)
        for row in str_rows:
            print(
                "|"
                + "|".join(f" {c.ljust(w)} " for c, w in zip(row, widths))
                + "|"
            )
        if rows:
            print(line)

    def record(self, data):
        rows = [[k, v] for k, v in data.items()]
        self.table(["key", "value"], rows)

    def message(self, text):
        print(text)

    def value(self, value):
        print(value)


class JsonOutput(Output):
    def table(self, header, rows):
        print(
            json.dumps(
                [dict(zip(header, row)) for row in rows], default=str
            )
        )

    def record(self, data):
        print(json.dumps(data, default=str))

    def message(self, text):
        print(json.dumps({"message": text}))

    def value(self, value):
        print(json.dumps(value, default=str))


class QuietOutput(Output):
    def table(self, header, rows):
        # id + status per line for single-key entity listings (reference
        # output/test_quiet.py: "1 FINISHED"); full rows for multi-key
        # tables (task lists, alloc info) where dropping columns would
        # lose the identifying ids
        lowered = [str(h).lower() for h in header]
        status_idx = (
            lowered.index("status") if "status" in lowered else None
        )
        compact = status_idx not in (None, 0) and lowered[0] == "id"
        for row in rows:
            if compact:
                print(f"{row[0]} {row[status_idx]}")
            else:
                print(" ".join(str(c) for c in row))

    def record(self, data):
        pass

    def message(self, text):
        pass

    def value(self, value):
        print(value)


def make_output(mode: str) -> Output:
    if mode == "json":
        return JsonOutput()
    if mode == "quiet":
        return QuietOutput()
    return CliOutput()


def fail(message: str) -> "NoReturn":  # noqa: F821
    print(f"error: {message}", file=sys.stderr)
    raise SystemExit(1)
