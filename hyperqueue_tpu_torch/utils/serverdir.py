"""Server directory and access records.

Reference: crates/hyperqueue/src/common/serverdir.rs:18-216 — a per-server
directory (default ~/.hq-tpu-server/NNN) holding access.json with host/ports
and the two pre-shared secret keys (client plane, worker plane), plus an
`hq-current` symlink to the newest instance. `generate-access` style
pre-shared deployment works by copying this file.

Federation: a federated deployment nests one classic server dir
per shard under the root (``<root>/shard-0000``, ``shard-0001``, ...), each
with its own instance dirs, journal, and lease file, plus a root-level
``federation.json`` naming the shard count. Job ids partition statically:
shard k of N owns every job id with ``(job_id - 1) % N == k``, so a job id
alone routes a client to its shard and shards allocate without
coordination. The port has the shard-path helpers; the descriptor
functions (`write_federation`, `grow_federation`, `load_federation`)
raise until the federation plane is ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import json
import os
import secrets
import time
from dataclasses import dataclass
from pathlib import Path
from hyperqueue_tpu_torch.utils import clock

ACCESS_FILE = "access.json"
CURRENT_LINK = "hq-current"
FEDERATION_FILE = "federation.json"
# failover rewrites the access record while workers/clients re-read it
# under --on-server-lost reconnect; a reader that catches the rename
# window (or a torn legacy writer) retries briefly instead of failing
LOAD_ACCESS_RETRY_SECS = 0.5
_LOAD_ACCESS_POLL = 0.02


@dataclass
class AccessRecord:
    server_uid: str
    host: str
    client_port: int
    worker_port: int
    client_key: str | None  # hex; None = auth disabled on that plane
    worker_key: str | None
    version: int = 1
    # server visible under a different hostname to workers than to clients
    # (reference serverdir.rs FullAccessRecord: per-plane host)
    worker_host: str | None = None

    def host_for_workers(self) -> str:
        return self.worker_host or self.host

    def to_json(self, role: str | None = None) -> dict:
        """Full record, or a split single-plane record when role is
        "client"/"worker" (reference `generate-access --client-file/
        --worker-file` splitting)."""
        out: dict = {"version": self.version, "server_uid": self.server_uid}
        if role in (None, "client"):
            out["client"] = {
                "host": self.host, "port": self.client_port,
                "key": self.client_key,
            }
        if role in (None, "worker"):
            out["worker"] = {
                "host": self.host_for_workers(), "port": self.worker_port,
                "key": self.worker_key,
            }
        return out

    @classmethod
    def from_json(cls, data: dict) -> "AccessRecord":
        client = data.get("client")
        worker = data.get("worker")
        if client is None and worker is None:
            raise ValueError("access record has neither client nor worker plane")
        return cls(
            server_uid=data["server_uid"],
            host=(client or worker)["host"],
            client_port=client["port"] if client else 0,
            worker_port=worker["port"] if worker else 0,
            client_key=client.get("key") if client else None,
            worker_key=worker.get("key") if worker else None,
            version=data.get("version", 1),
            worker_host=worker["host"] if worker else None,
        )

    def client_key_bytes(self) -> bytes | None:
        return bytes.fromhex(self.client_key) if self.client_key else None

    def worker_key_bytes(self) -> bytes | None:
        return bytes.fromhex(self.worker_key) if self.worker_key else None


def default_server_dir() -> Path:
    root = os.environ.get("HQ_SERVER_DIR")
    if root:
        return Path(root)
    return Path.home() / ".hq-tpu-server"


# server uids land in the journal (server-uid lineage records), so a
# deterministic simulation must be able to derive them from a seed; the
# default stays the OS entropy pool. Key material also flows through this
# source — a simulation that wants encryption must accept that a seeded
# source makes those keys predictable (the sim runs auth-disabled).
_token_source = secrets.token_hex


def set_token_source(source) -> object:
    """Swap the uid/key entropy source (``fn(nbytes) -> hex str``);
    returns the previous source.  None restores ``secrets.token_hex``."""
    global _token_source
    previous = _token_source
    _token_source = source if source is not None else secrets.token_hex
    return previous


def generate_access(
    host: str,
    client_port: int,
    worker_port: int,
    disable_client_auth: bool = False,
    disable_worker_auth: bool = False,
    worker_host: str | None = None,
) -> AccessRecord:
    return AccessRecord(
        server_uid=_token_source(8),
        host=host,
        client_port=client_port,
        worker_port=worker_port,
        client_key=None if disable_client_auth else _token_source(32),
        worker_key=None if disable_worker_auth else _token_source(32),
        worker_host=worker_host,
    )


def create_instance_dir(server_dir: Path) -> Path:
    """Create server_dir/NNN (next free number) and point hq-current at it."""
    server_dir.mkdir(parents=True, exist_ok=True)
    n = 1
    existing = [
        int(p.name) for p in server_dir.iterdir() if p.name.isdigit()
    ]
    if existing:
        n = max(existing) + 1
    instance = server_dir / f"{n:03d}"
    instance.mkdir()
    link = server_dir / CURRENT_LINK
    tmp = server_dir / f".{CURRENT_LINK}.tmp"
    if tmp.is_symlink() or tmp.exists():
        tmp.unlink()
    tmp.symlink_to(instance.name)
    tmp.replace(link)
    return instance


def store_access(instance_dir: Path, record: AccessRecord) -> None:
    # atomic: the hq-current symlink already points at this instance dir
    # (create_instance_dir flips it first), so reconnecting workers and
    # retrying clients poll this path — they must see nothing or the whole
    # record, never a torn write. The rename must also survive a crash of
    # the PUBLISHER (a promoted successor dying right after failover must
    # not leave the old, dead address on disk): fsync the dir too.
    path = instance_dir / ACCESS_FILE
    tmp = instance_dir / f".{ACCESS_FILE}.tmp"
    with open(tmp, "w") as f:
        json.dump(record.to_json(), f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.chmod(tmp, 0o600)
    tmp.replace(path)
    from hyperqueue_tpu_torch.events.journal import fsync_dir

    fsync_dir(instance_dir)


def _read_access_file(path: Path) -> AccessRecord:
    with open(path) as f:
        return AccessRecord.from_json(json.load(f))


def load_access(
    server_dir: Path, retry_secs: float | None = None
) -> AccessRecord:
    """Load the current instance's access record.

    Tolerates a record mid-rewrite: shard failover publishes a NEW
    instance dir + access record while reconnecting workers and retrying
    clients re-read this path, and a non-atomic writer (an out-of-tree
    tool editing access.json in place) can expose a torn prefix. A parse
    error or a file vanishing between the symlink hop and the open is
    retried for a short window before it propagates.
    """
    window = LOAD_ACCESS_RETRY_SECS if retry_secs is None else retry_secs
    deadline = clock.monotonic() + window
    while True:
        direct = server_dir / ACCESS_FILE
        try:
            if direct.exists():
                return _read_access_file(direct)
            current = server_dir / CURRENT_LINK
            path = current / ACCESS_FILE
            if not path.exists():
                raise FileNotFoundError(
                    f"no running server found in {server_dir} "
                    f"(missing {ACCESS_FILE})"
                )
            return _read_access_file(path)
        except FileNotFoundError:
            # the instance dir exists but its record does not (yet): only
            # a publish-in-progress window is worth riding out — with no
            # hq-current symlink at all, fail fast with the clear message
            if not (server_dir / CURRENT_LINK).is_symlink():
                raise
            if clock.monotonic() >= deadline:
                raise
        except (ValueError, KeyError, TypeError):
            # torn/mid-rewrite record (json decode errors are ValueError);
            # retry briefly, then let the real error out
            if clock.monotonic() >= deadline:
                raise
        time.sleep(_LOAD_ACCESS_POLL)


# ------------------------------------------------------------- federation
def shard_dir_name(shard_id: int) -> str:
    return f"shard-{shard_id:04d}"


def shard_path(root: Path, shard_id: int) -> Path:
    return Path(root) / shard_dir_name(shard_id)


def shard_id_of(server_dir: Path) -> int | None:
    """Shard id encoded in a shard server-dir name, or None."""
    name = Path(server_dir).name
    if name.startswith("shard-") and name[6:].isdigit():
        return int(name[6:])
    return None


def shard_for_job(job_id: int, shard_count: int) -> int:
    """The modulo partition primitive (static; ids are 1-based).

    This is only the PRE-MIGRATION fallback: live routing
    must go through ``client/routing.py``'s resolver, which consults the
    ownership map first (committed migrations and online-added shards
    re-home job ids away from this arithmetic)."""
    return (int(job_id) - 1) % max(int(shard_count), 1)


# the federation descriptor (write, online growth and its ownership-log
# record, load) comes with the federation plane
_ITEM_10 = (
    "ROADMAP Queue 1 item 10 (autoalloc, federation, leases, ownership "
    "and the chaos plane)"
)


def write_federation(root: Path, shard_count: int) -> dict:
    raise NotImplementedError(
        f"the federation descriptor comes with {_ITEM_10}"
    )


def grow_federation(root: Path, shard_count: int) -> dict:
    raise NotImplementedError(
        f"the federation descriptor comes with {_ITEM_10}"
    )


def load_federation(root: Path) -> dict | None:
    raise NotImplementedError(
        f"the federation descriptor comes with {_ITEM_10}"
    )
