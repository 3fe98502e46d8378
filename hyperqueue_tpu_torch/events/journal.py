"""Append-only event journal with torn-tail tolerance and per-record CRCs.

The port's copy of the JAX package's journal: the same file format byte for
byte, with the payloads encoded by `transport/codec` (msgpack's wire format
over the standard library) instead of the msgpack package.

Reference: crates/hyperqueue/src/server/event/journal/ — header-versioned
append-only file of serialized events (`hqjl0002`, write.rs:12-76), flushed
periodically and synchronously after client-visible mutations; a torn tail
(crash mid-write) is detected and truncated on restore (read.rs:60); pruning
rewrites the file dropping completed jobs (prune.rs).

Format here (v2, magic "hqtpujl2"): 8-byte magic, then records of
[u32-LE length][u32-LE CRC32 of payload][msgpack payload]. v1 files
(magic "hqtpujl1", no CRC) are read transparently; any rewrite (prune,
compaction GC) upgrades to v2.

The CRC lets the reader tell two very different failures apart:

- **torn tail** — a crash mid-write left an incomplete (or CRC-bad) final
  record at EOF. Expected under kill -9; silently truncated.
- **mid-file corruption** — a complete record whose CRC does not match,
  with more records after it (bit rot, partial sector writes). NOT a crash
  artifact: raises `JournalCorruption` loudly. `salvage=True`
  (`hq server start --journal-salvage`) skips such records instead,
  counting them in `hq_journal_salvaged_records_total`.
"""

from __future__ import annotations

import logging
import os
import struct
import time
import zlib
from pathlib import Path

from hyperqueue_tpu_torch.transport import codec
from hyperqueue_tpu_torch.utils.metrics import REGISTRY

MAGIC = b"hqtpujl2"
MAGIC_V1 = b"hqtpujl1"
_LEN = struct.Struct("<I")
_LEN_CRC = struct.Struct("<II")

logger = logging.getLogger("hq.journal")

# fsync stalls are the journal's dominant latency risk (--journal-fsync
# always puts one on every event); the histogram makes a slow disk visible
# on the metrics plane instead of as mystery event-loop hiccups
_FSYNC_SECONDS = REGISTRY.histogram(
    "hq_journal_fsync_seconds", "journal fsync latency"
)
_WRITES_TOTAL = REGISTRY.counter(
    "hq_journal_writes_total", "journal records appended"
)
_BYTES_TOTAL = REGISTRY.counter(
    "hq_journal_bytes_total", "journal payload bytes appended"
)
_SALVAGED_TOTAL = REGISTRY.counter(
    "hq_journal_salvaged_records_total",
    "corrupt mid-file journal records skipped in salvage mode",
)


class JournalCorruption(RuntimeError):
    """A complete journal record failed its CRC (or decode) mid-file.

    Distinct from a torn tail: a torn tail is the expected artifact of a
    crash mid-append and is silently truncated; mid-file corruption means
    the bytes on disk changed after they were written."""


def fsync_dir(path: Path) -> None:
    """fsync a directory so a rename inside it is durable.

    `os.replace` alone is NOT crash-durable: the rename lives in the
    directory, and a crash before the directory metadata reaches disk can
    resurrect the old file. Every atomic-rename in the durability layer
    (snapshot publish, prune, compaction GC swap) must be followed by
    this."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _frame(data: bytes, version: int) -> bytes:
    if version >= 2:
        return _LEN_CRC.pack(len(data), zlib.crc32(data)) + data
    return _LEN.pack(len(data)) + data


def _sniff_version(path: Path) -> int:
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    if head == MAGIC:
        return 2
    if head == MAGIC_V1:
        return 1
    raise ValueError(f"{path} is not a journal file")


def _read_frames(f, version: int, path, salvage: bool, stop_at=None):
    """Yield (payload, record_start) for complete, CRC-valid frames.

    Stops (torn tail) when the final frame is incomplete or — v2 — its CRC
    fails AND it extends to EOF/stop_at. A CRC failure with more data after
    it is mid-file corruption: raise JournalCorruption, or with `salvage`
    skip the record, bump the salvage counter, and keep going (the framing
    itself is intact, so the next record is findable)."""
    header_struct = _LEN_CRC if version >= 2 else _LEN
    end = stop_at
    while True:
        start = f.tell()
        if end is not None and start >= end:
            return
        header = f.read(header_struct.size)
        if len(header) < header_struct.size:
            return  # torn tail: incomplete header
        if version >= 2:
            length, crc = header_struct.unpack(header)
        else:
            (length,) = header_struct.unpack(header)
            crc = None
        payload = f.read(length)
        if len(payload) < length:
            return  # torn tail: incomplete payload
        if crc is not None and zlib.crc32(payload) != crc:
            record_end = f.tell()
            f.seek(0, os.SEEK_END)
            file_end = f.tell()
            f.seek(record_end)
            if record_end >= (end if end is not None else file_end):
                # the bad record is the last thing in the file: a partial
                # sector write at the crash point, i.e. a torn tail
                return
            if not salvage:
                raise JournalCorruption(
                    f"{path}: record at byte {start} failed its CRC with "
                    f"{file_end - record_end} bytes of journal after it — "
                    "mid-file corruption, not a torn tail (re-run with "
                    "--journal-salvage to skip bad records)"
                )
            _SALVAGED_TOTAL.inc()
            logger.error(
                "salvage: skipping corrupt journal record at byte %d of %s",
                start, path,
            )
            continue
        yield payload, start


class Journal:
    def __init__(self, path: Path, salvage: bool = False):
        self.path = Path(path)
        self.salvage = salvage
        self._file = None
        self._version = 2
        # group-commit buffer: while a batch is open, framed records
        # accumulate here and hit the file as ONE write at commit — the
        # completion plane's per-batch cost is one os.write (+ one fsync
        # under --journal-fsync always) instead of one per task event
        self._batch: list[bytes] | None = None

    def open_for_append(self) -> None:
        exists = self.path.exists() and self.path.stat().st_size >= len(MAGIC)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if exists:
            # an existing file keeps its framing version (mixed framing in
            # one file would be unreadable); rewrites upgrade to v2
            self._version = _sniff_version(self.path)
            # drop a torn tail before appending
            valid_end = self._scan_valid_end()
            self._file = open(self.path, "r+b")
            self._file.truncate(valid_end)
            self._file.seek(valid_end)
        else:
            self._version = 2
            self._file = open(self.path, "wb")
            self._file.write(MAGIC)
            self._file.flush()

    def _scan_valid_end(self) -> int:
        with open(self.path, "rb") as f:
            f.seek(len(MAGIC))
            pos = len(MAGIC)
            for _payload, _start in _read_frames(
                f, self._version, self.path, self.salvage
            ):
                pos = f.tell()
            return pos

    def write(self, record: dict) -> None:
        data = codec.packb(record)
        framed = _frame(data, self._version)
        if self._batch is not None:
            self._batch.append(framed)
        else:
            self._file.write(framed)
        _WRITES_TOTAL.inc()
        _BYTES_TOTAL.inc(len(data))

    @property
    def in_batch(self) -> bool:
        """True while a group-commit batch is open (writes are buffered)."""
        return self._batch is not None

    def begin_batch(self) -> None:
        """Buffer subsequent writes until commit_batch (idempotent)."""
        if self._batch is None:
            self._batch = []

    def commit_batch(self) -> int:
        """Write the buffered batch as one append; returns records written.
        The batch is closed either way — callers decide the flush/fsync."""
        buf, self._batch = self._batch, None
        if not buf:
            return 0
        self._file.write(b"".join(buf))
        return len(buf)

    def flush(self, sync: bool = False) -> None:
        if self._file is not None:
            if self._batch:
                # a flush demanded mid-batch (explicit `hq journal flush`,
                # history replay) must see every written record on disk
                buf, self._batch = self._batch, []
                self._file.write(b"".join(buf))
            self._file.flush()
            if sync:
                t0 = time.perf_counter()
                os.fsync(self._file.fileno())
                _FSYNC_SECONDS.observe(time.perf_counter() - t0)

    def close(self) -> None:
        if self._file is not None:
            if self._batch:
                self.commit_batch()
            self._batch = None
            self.flush(sync=True)
            self._file.close()
            self._file = None

    def kill(self) -> None:
        """Abandon the appender with kill -9 semantics: whatever the flush
        policy already pushed to the OS stays on disk, everything still in
        the user-space buffer (an open group-commit batch, bytes the
        BufferedWriter holds) is LOST — exactly what a SIGKILL of the
        process would leave behind.  The deterministic simulator uses this
        to model server death without ending the test process.

        The buffered file object cannot simply be dropped (Python flushes
        on finalize, which would resurrect the "lost" tail — possibly
        AFTER a restored appender wrote past it) nor os.close()d (the fd
        number could be reused before the finalizer runs and the flush
        would land in an unrelated file).  Redirecting the fd to /dev/null
        makes the eventual flush+close harmless and exact."""
        if self._file is None:
            return
        self._batch = None
        devnull = os.open(os.devnull, os.O_WRONLY)
        try:
            os.dup2(devnull, self._file.fileno())
        finally:
            os.close(devnull)
        try:
            self._file.close()  # flushes the doomed buffer into /dev/null
        except OSError:
            pass
        self._file = None

    @staticmethod
    def read_all(path: Path, salvage: bool = False):
        """Yield records, silently stopping at a torn tail (reference
        read.rs:109-235 tests this tolerance). Mid-file corruption raises
        JournalCorruption unless `salvage` (see module docstring)."""
        version = _sniff_version(path)
        with open(path, "rb") as f:
            f.seek(len(MAGIC))
            for payload, start in _read_frames(f, version, path, salvage):
                try:
                    yield codec.unpackb(payload)
                except Exception:
                    if version < 2:
                        # v1 has no CRC: an undecodable record is
                        # indistinguishable from a torn tail — keep the
                        # legacy stop-here tolerance
                        return
                    # v2: the CRC matched but msgpack failed — the record
                    # was written broken; same policy as a CRC failure
                    if not salvage:
                        raise JournalCorruption(
                            f"{path}: CRC-valid record at byte {start} "
                            "failed to decode"
                        )
                    _SALVAGED_TOTAL.inc()
                    logger.error(
                        "salvage: skipping undecodable journal record at "
                        "byte %d of %s", start, path,
                    )

    @staticmethod
    def prune(path: Path, keep_jobs: set[int], salvage: bool = False) -> int:
        """Rewrite the journal keeping only events of `keep_jobs` (live jobs);
        worker lifecycle events are dropped. Returns records kept."""
        tmp = Path(str(path) + ".prune")
        kept = 0
        with open(tmp, "wb") as out:
            out.write(MAGIC)  # rewrites always upgrade to v2 framing
            for record in Journal.read_all(path, salvage=salvage):
                job = record.get("job")
                if job is not None and job not in keep_jobs:
                    continue
                if job is None:
                    # worker/overview events are not restorable state — but
                    # the server-uid lineage records must survive, or a
                    # post-prune restore could never verify reattach claims
                    if record.get("event") != "server-uid":
                        continue
                data = codec.packb(record)
                out.write(_frame(data, 2))
                kept += 1
            out.flush()
            os.fsync(out.fileno())
        tmp.replace(path)
        # without this, a crash after the rename can resurrect the
        # pre-prune journal — the rename lives in directory metadata
        fsync_dir(path.parent)
        return kept

    @staticmethod
    def gc_rewrite(
        path: Path,
        tmp: Path,
        keep_jobs: set[int],
        watermark: int,
        stop_at: int,
        salvage: bool = False,
    ) -> tuple[int, int]:
        """Compaction GC: rewrite the pre-snapshot region [magic, stop_at)
        into `tmp`, dropping events already superseded by the snapshot.

        Kept: records of still-live jobs (so `journal stream --history`
        keeps their timeline), server-uid lineage records (so a fallback
        full replay still fences instance generations), and — defensively —
        anything at/after the snapshot seq watermark. Dropped: completed/
        forgotten jobs' events and worker lifecycle noise, all of which the
        snapshot carries in O(live-state) form.

        Runs against a live appender: only bytes below `stop_at` (the file
        size at the compaction barrier) are read, so concurrent appends are
        invisible here and are carried over by `finalize` afterwards.
        Output is always v2 framing. Returns (kept, dropped)."""
        from hyperqueue_tpu_torch.utils import chaos

        version = _sniff_version(path)
        kept = dropped = 0
        with open(path, "rb") as src, open(tmp, "wb") as out:
            out.write(MAGIC)
            src.seek(len(MAGIC))
            for payload, _start in _read_frames(
                src, version, path, salvage, stop_at=stop_at
            ):
                try:
                    record = codec.unpackb(payload)
                except Exception:
                    if version >= 2 and not salvage:
                        raise JournalCorruption(
                            f"{path}: undecodable record during compaction"
                        )
                    dropped += 1
                    continue
                seq = record.get("seq")
                job = record.get("job")
                keep = (
                    (isinstance(seq, int) and seq >= watermark)
                    or (job is not None and job in keep_jobs)
                    or record.get("event") == "server-uid"
                )
                if not keep:
                    dropped += 1
                    continue
                out.write(_frame(payload, 2))
                kept += 1
                if chaos.ACTIVE:
                    chaos.fire("server.compact", event="mid-gc")
            out.flush()
            os.fsync(out.fileno())
        return kept, dropped

    @staticmethod
    def gc_finalize(path: Path, tmp: Path, stop_at: int) -> None:
        """Carry the frames appended after `stop_at` (events that arrived
        during the GC rewrite) onto `tmp`, then atomically publish `tmp` as
        the journal. The caller must have closed/quiesced the appender: the
        open handle would keep writing to the replaced inode otherwise."""
        version = _sniff_version(path)
        with open(path, "rb") as src, open(tmp, "r+b") as out:
            out.seek(0, os.SEEK_END)
            src.seek(stop_at)
            # re-frame rather than raw-copy: the tail may be v1 framing
            # while tmp is always v2
            for payload, _start in _read_frames(src, version, path, True):
                out.write(_frame(payload, 2))
            out.flush()
            os.fsync(out.fileno())
        tmp.replace(path)
        fsync_dir(path.parent)
