"""Output streaming: task stdout/stderr multiplexed into per-worker log files.

Reference: crates/hyperqueue/src/worker/streamer.rs (worker side: chunks of
task stdout/stderr appended to `<dir>/<uid>.hqs`, header `hqsf0000`) and
crates/hyperqueue/src/stream/reader/outputlog.rs (reader: merge files, index
by task/instance/channel, superseded-instance filtering; CLI `hq output-log
{summary,cat,show,export}`).

Format here: header magic "hqtpusf1", then msgpack records
{t: task_id, i: instance, c: 0|1 (stdout|stderr), d: bytes} with u32-LE
length prefixes. A `close` record (c: 2) marks a task's stream complete.
The records are encoded by `transport/codec`, so the files are the JAX
package's byte for byte.
"""

from __future__ import annotations

import struct
from pathlib import Path

from hyperqueue_tpu_torch.transport import codec

MAGIC = b"hqtpusf1"
_LEN = struct.Struct("<I")

STDOUT = 0
STDERR = 1
CLOSE = 2


class StreamWriter:
    """Worker-side appender; one per (worker, stream dir)."""

    def __init__(self, directory: str | Path, worker_id: int, server_uid: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{server_uid}.{worker_id}.hqs"
        fresh = not self.path.exists()
        self._file = open(self.path, "ab")
        if fresh:
            self._file.write(MAGIC)
            self._file.flush()

    def write_chunk(self, task_id: int, instance: int, channel: int,
                    data: bytes) -> None:
        record = codec.packb(
            {"t": task_id, "i": instance, "c": channel, "d": data}
        )
        self._file.write(_LEN.pack(len(record)) + record)
        self._file.flush()

    def close_task(self, task_id: int, instance: int) -> None:
        self.write_chunk(task_id, instance, CLOSE, b"")

    def close(self) -> None:
        self._file.close()


class OutputLog:
    """Reader over all .hqs files in a stream directory."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        # task_id -> instance -> channel -> [bytes]
        self.chunks: dict[int, dict[int, dict[int, list[bytes]]]] = {}
        self.closed: set[tuple[int, int]] = set()
        for path in sorted(self.dir.glob("*.hqs")):
            self._read_file(path)

    def _read_file(self, path: Path) -> None:
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                return
            while True:
                header = f.read(_LEN.size)
                if len(header) < _LEN.size:
                    return
                (length,) = _LEN.unpack(header)
                payload = f.read(length)
                if len(payload) < length:
                    return
                rec = codec.unpackb(payload, strict_map_key=False)
                task, inst, chan = rec["t"], rec["i"], rec["c"]
                if chan == CLOSE:
                    self.closed.add((task, inst))
                    continue
                self.chunks.setdefault(task, {}).setdefault(inst, {}) \
                    .setdefault(chan, []).append(rec["d"])

    def _live_instance(self, task_id: int) -> int | None:
        """Highest instance wins; superseded instances are filtered
        (reference outputlog.rs superseded-instance logic)."""
        instances = self.chunks.get(task_id)
        if not instances:
            return None
        return max(instances)

    def task_ids(self) -> list[int]:
        return sorted(self.chunks)

    def job_ids(self) -> list[int]:
        """Job ids present in the stream dir (reference outputlog.rs:349
        `jobs()` — prints the index's job keys)."""
        from hyperqueue_tpu_torch.ids import task_id_job

        return sorted({task_id_job(t) for t in self.chunks})

    def cat(self, task_id: int, channel: int) -> bytes:
        inst = self._live_instance(task_id)
        if inst is None:
            return b""
        return b"".join(self.chunks[task_id][inst].get(channel, []))

    def summary(self) -> dict:
        n_chunks = 0
        n_bytes = 0
        for instances in self.chunks.values():
            for channels in instances.values():
                for chunk_list in channels.values():
                    n_chunks += len(chunk_list)
                    n_bytes += sum(len(c) for c in chunk_list)
        return {
            "files": len(list(self.dir.glob("*.hqs"))),
            "tasks": len(self.chunks),
            "chunks": n_chunks,
            "bytes": n_bytes,
            "closed_streams": len(self.closed),
        }

    def export(self):
        """Yield {task, instance, channel, data} dicts (NDJSON-able)."""
        from hyperqueue_tpu_torch.ids import task_id_job, task_id_task

        for task_id in self.task_ids():
            inst = self._live_instance(task_id)
            for chan in (STDOUT, STDERR):
                data = b"".join(self.chunks[task_id][inst].get(chan, []))
                if data:
                    yield {
                        "job": task_id_job(task_id),
                        "task": task_id_task(task_id),
                        "instance": inst,
                        "channel": "stdout" if chan == STDOUT else "stderr",
                        "data": data.decode(errors="replace"),
                    }
