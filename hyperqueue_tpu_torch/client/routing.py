"""Client-side job routing: ONE resolver for "which shard owns job X".

The port's copy of the JAX package's `client/routing.py`. Before the
ownership map existed, every caller —
FederatedSession, serverdir helpers, the CLI — re-derived the modulo
``(job_id - 1) % shard_count`` inline, which is exactly the arithmetic
that goes stale the moment a job migrates. All routing now funnels
through :class:`Resolver`, which consults the federation root's
ownership log (utils/ownership.py) and falls back to the modulo only
when the log is absent or empty (a pre-migration federation — where the
modulo is still exact by construction).

The resolver CACHES its ownership-map read: clients route thousands of
requests and must not re-read a file per call. Staleness is handled by
the protocol, not by polling — a shard that no longer owns a job answers
``{"op": "error", "code": "wrong-shard", "owner": k}``, the caller
invokes :meth:`Resolver.refresh` and retries once toward the owner.
"""

from __future__ import annotations

from pathlib import Path

from hyperqueue_tpu_torch.utils import serverdir


class Resolver:
    """Cached ownership-map routing for one federation root."""

    def __init__(self, root: Path, shard_count: int = 1):
        self.root = Path(root)
        # the descriptor count the caller booted with: the modulo
        # fallback when no ownership log exists yet
        self._fallback_count = max(int(shard_count), 1)
        self._map = None
        self._loaded = False

    def _load(self):
        if not self._loaded:
            from hyperqueue_tpu_torch.utils.ownership import OwnershipStore

            try:
                self._map = OwnershipStore(self.root).load()
            except Exception:  # noqa: BLE001 - no log = modulo routing
                self._map = None
            self._loaded = True
        return self._map

    @property
    def shard_count(self) -> int:
        """Effective shard count — includes shards added online, which
        the boot-time descriptor snapshot a session cached may predate."""
        m = self._load()
        if m is not None:
            return max(m.shard_count, self._fallback_count)
        return self._fallback_count

    def shard_for_job(self, job_id: int) -> int:
        m = self._load()
        if m is not None:
            return m.shard_for_job(job_id)
        return serverdir.shard_for_job(job_id, self._fallback_count)

    def refresh(self) -> None:
        """Drop the cached map; the next route re-reads the log. Called
        on a wrong-shard redirect (the one signal the cache is stale)."""
        self._map = None
        self._loaded = False
