"""Structured logging: `--log-format json` on server and worker.

A JSON log line carries the same correlation keys the metrics plane and the
flight recorder use — ``tick``, ``job``, ``task``, ``worker``,
``instance``, ``reason`` — so one `jq` pass can join a log stream with
DecisionRecords and Prometheus series.  Call sites attach them through the
stdlib ``extra=`` mechanism::

    logger.warning("worker %d heartbeat timeout", wid, extra={"worker": wid})

Plain format stays the historical human-readable default.
"""

from __future__ import annotations

import json
import logging
import os

# correlation keys promoted from LogRecord attributes into the JSON line
CONTEXT_FIELDS = ("tick", "job", "task", "worker", "instance", "reason")

LOG_FORMATS = ("plain", "json")


class JsonLogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key in CONTEXT_FIELDS:
            value = record.__dict__.get(key)
            if value is not None:
                out[key] = value
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(log_format: str | None = None, level: str | None = None):
    """Configure root logging for a server/worker process.

    `log_format`: "plain" | "json"; None falls back to $HQ_LOG_FORMAT then
    plain. `level` falls back to $HQ_LOG then INFO.
    """
    if log_format is None:
        log_format = os.environ.get("HQ_LOG_FORMAT", "plain")
    if log_format not in LOG_FORMATS:
        raise ValueError(f"unknown log format {log_format!r}")
    handler = logging.StreamHandler()
    if log_format == "json":
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"
        ))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel((level or os.environ.get("HQ_LOG", "INFO")).upper())
    return handler
