"""The port's sampling profiler against the JAX package's, on the CPU.

The unit cases of tests/test_profiler.py (everything but its `HqEnv`
end-to-end cases) run twinned: each against both packages (`pkg`
parametrizes them; each package has its own plane registry and profiler).
Then both folded tries fed the same stacks must render the same folded
text. The server-side cases (the stats block, `hq server profile` in its
continuous and burst modes, reset-metrics) run against the port's server
in tests/test_torch_server_e2e.py.
"""

from __future__ import annotations

import random
import threading
import time
import types

import pytest
import torch

from hyperqueue_tpu.utils import clock as jax_clock
from hyperqueue_tpu.utils import profiler as jax_profiler
from hyperqueue_tpu_torch.utils import clock as port_clock
from hyperqueue_tpu_torch.utils import profiler as port_profiler
from utils_e2e import wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.profile

PKGS = {
    "jax": types.SimpleNamespace(name="jax", profiler=jax_profiler,
                                 clock=jax_clock),
    "port": types.SimpleNamespace(name="port", profiler=port_profiler,
                                  clock=port_clock),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


# ----------------------------------------------------------- folded trie
def test_folded_trie_counts_and_golden_render(pkg):
    P, C = pkg.profiler, pkg.clock
    trie = P.FoldedTrie()
    trie.fold("reactor", ("main.run", "loop.tick"), 3)
    trie.fold("reactor", ("main.run", "loop.tick", "solve.call"))
    trie.fold("solve", ("worker.loop",), 2)
    counts = trie.counts()
    assert counts == {
        "reactor;main.run;loop.tick": 3,
        "reactor;main.run;loop.tick;solve.call": 1,
        "solve;worker.loop": 2,
    }
    # golden: flamegraph folded text, one `stack count` line, sorted
    assert P.render_folded(counts) == (
        "reactor;main.run;loop.tick 3\n"
        "reactor;main.run;loop.tick;solve.call 1\n"
        "solve;worker.loop 2\n"
    )


def test_folded_trie_bounded_memory_truncated_sink(pkg):
    P, C = pkg.profiler, pkg.clock
    trie = P.FoldedTrie(max_nodes=64)
    n_folds = 500
    for i in range(n_folds):
        # every stack unique: must blow the node budget quickly
        trie.fold("plane", (f"mod.f{i}", f"mod.g{i}", f"mod.h{i}"))
    # the bound holds no matter how many unique stacks arrive (+1 slack
    # for the pre-budgeted per-level (truncated) sink node)
    assert trie.nodes <= trie.max_nodes + 1
    assert trie.dropped > 0
    counts = trie.counts()
    # no sample is lost — long-tail stacks degrade into the sink
    assert sum(counts.values()) == n_folds
    assert any(P.TRUNCATED in stack for stack in counts)
    # clear() releases everything
    trie.clear()
    assert trie.nodes == 0 and trie.dropped == 0 and trie.counts() == {}


def test_folded_trie_minimum_budget_clamped(pkg):
    P, C = pkg.profiler, pkg.clock
    trie = P.FoldedTrie(max_nodes=1)
    assert trie.max_nodes == 64
    trie.fold("p", ("a.b",))
    assert trie.counts() == {"p;a.b": 1}


def test_diff_counts_window_view(pkg):
    P, C = pkg.profiler, pkg.clock
    before = {"p;a": 5, "p;b": 2, "p;gone": 9}
    after = {"p;a": 8, "p;b": 2, "p;new": 4, "p;gone": 9}
    # only positive growth survives: unchanged and disappeared drop out
    assert P.diff_counts(after, before) == {"p;a": 3, "p;new": 4}


# --------------------------------------------------------- plane registry
def test_plane_registration_unregistration_and_restart(pkg):
    P, C = pkg.profiler, pkg.clock
    ident = 999_000_001  # fake thread ident — never collides with a real one
    P.register_plane("journal", ident=ident)
    assert P.registered_planes()[ident] == "journal"
    assert P.plane_of(ident, "whatever") == "journal"
    # a restarted thread re-registers and simply overwrites
    P.register_plane("journal-v2", ident=ident)
    assert P.plane_of(ident, "whatever") == "journal-v2"
    P.unregister_plane(ident=ident)
    assert ident not in P.registered_planes()
    # double-unregister is a no-op
    P.unregister_plane(ident=ident)


def test_plane_prefix_fallback_for_pool_threads(pkg):
    P, C = pkg.profiler, pkg.clock
    # ThreadPoolExecutor names lazily-spawned workers `<prefix>_N` long
    # after the pool existed to register anything — name-prefix fallback
    assert P.plane_of(999_000_002, "hq-fanout_3") == "fanout"
    assert P.plane_of(999_000_002, "hq-journal") == "journal"
    assert P.plane_of(999_000_002, "hq-solve-watchdog") == "solve"
    assert P.plane_of(999_000_002, "hq-device-solver_0") == "solve"
    assert P.plane_of(999_000_002, "ThreadPoolExecutor-0_1") == "other"
    # explicit registration wins over the prefix table
    P.register_plane("special", ident=999_000_003)
    try:
        assert P.plane_of(999_000_003, "hq-fanout_0") == "special"
    finally:
        P.unregister_plane(ident=999_000_003)
    # a new prefix can be added (and re-pointed) at runtime
    P.register_plane_prefix("hq-proftest", "proftest")
    assert P.plane_of(999_000_004, "hq-proftest_7") == "proftest"
    P.register_plane_prefix("hq-proftest", "proftest2")
    assert P.plane_of(999_000_004, "hq-proftest_7") == "proftest2"


def test_wait_leaf_classification(pkg):
    P, C = pkg.profiler, pkg.clock
    assert P.is_wait_leaf("/usr/lib/python3.10/threading.py", "wait")
    assert P.is_wait_leaf("/usr/lib/python3.10/selectors.py", "select")
    assert P.is_wait_leaf("queue.py", "get")
    assert not P.is_wait_leaf("/usr/lib/python3.10/threading.py", "run")
    assert not P.is_wait_leaf("myapp.py", "wait")


# ------------------------------------------------- deterministic sampling
class _Threads:
    """One busy thread + one parked thread, each plane-registered."""

    def __init__(self, P):
        self.P = P
        self.stop = threading.Event()
        self.parked = threading.Event()
        self.busy = threading.Thread(
            target=self._spin, name="proftest-busy", daemon=True
        )
        self.waiter = threading.Thread(
            target=self._park, name="proftest-park", daemon=True
        )

    def _spin(self):
        self.P.register_plane("busyplane")
        try:
            while not self.stop.is_set():
                sum(i * i for i in range(500))
        finally:
            self.P.unregister_plane()

    def _park(self):
        self.P.register_plane("parkplane")
        try:
            self.parked.wait()  # leaf = threading.py:wait -> idle
        finally:
            self.P.unregister_plane()

    def __enter__(self):
        self.busy.start()
        self.waiter.start()
        time.sleep(0.05)  # let both reach their steady state
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.parked.set()
        self.busy.join(timeout=2)
        self.waiter.join(timeout=2)


def test_sample_once_attributes_active_vs_idle(pkg):
    P, C = pkg.profiler, pkg.clock
    prof = P.SamplingProfiler(hz=50.0)
    with _Threads(P):
        for _ in range(8):
            prof.sample_once(skip={threading.get_ident()})
            time.sleep(0.01)
        shares = prof.plane_shares()
    # the spinning thread is ACTIVE CPU on its plane
    assert shares["busyplane"]["samples"] == 8
    assert shares["busyplane"]["active"] >= 6
    assert shares["busyplane"]["cpu"] > 0.5
    # the parked thread is sampled but idle: blocked in threading.wait
    assert shares["parkplane"]["samples"] == 8
    assert shares["parkplane"]["active"] == 0
    assert shares["parkplane"]["cpu"] == 0.0
    # folded stacks carry the plane prefix and the registered function
    folded = prof.folded_counts()
    busy_stacks = [s for s in folded if s.startswith("busyplane;")]
    assert busy_stacks and any("_spin" in s for s in busy_stacks)
    assert prof.passes == 8
    assert prof.samples >= 16
    snap = prof.snapshot()
    assert snap["window_passes"] == 8
    assert snap["trie"]["nodes"] > 0


def test_stall_burst_and_counter_track_views(pkg):
    P, C = pkg.profiler, pkg.clock
    prof = P.SamplingProfiler(hz=50.0)
    with _Threads(P):
        for _ in range(6):
            prof.sample_once(skip={threading.get_ident()})
            time.sleep(0.01)
    burst = prof.stall_burst(window_s=30.0, limit=40)
    assert burst, "ring should hold the recent samples"
    by_plane = {row["plane"] for row in burst}
    assert "busyplane" in by_plane and "parkplane" in by_plane
    # rows aggregate identical stacks and sort by count desc
    counts = [row["count"] for row in burst]
    assert counts == sorted(counts, reverse=True)
    assert all(
        set(row) == {"plane", "stack", "active", "count"} for row in burst
    )
    # limit is honoured
    assert len(prof.stall_burst(window_s=30.0, limit=1)) == 1
    # an empty window (cutoff in the future) yields nothing
    assert prof.stall_burst(window_s=0.0) == []
    # the Perfetto counter track only counts ACTIVE samples
    track = prof.counter_track(bucket_s=0.5)
    assert "busyplane" in track
    assert "parkplane" not in track
    for series in track.values():
        assert all(cores > 0 for _t, cores in series)


def test_ring_views_while_the_sampler_appends():
    """The port's stall_burst and counter_track read the sample ring on
    the reactor's thread while the sampler thread appends to it, and
    never raise. (The JAX package's iterate the deque itself and raise
    "deque mutated during iteration" under the same load; on a server the
    stall capture of a long client request raised in `note_plane` and
    lost that request's reply.)"""
    import sys

    prof = port_profiler.SamplingProfiler(hz=50.0, ring_capacity=4096)
    for _ in range(4096):
        prof.ring.append((time.time(), "plane", "a;b", True))
    stop = threading.Event()

    def feed():
        while not stop.is_set():
            prof.ring.append((time.time(), "plane", "a;b", True))

    feeder = threading.Thread(target=feed, daemon=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    views = 0
    try:
        feeder.start()
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            assert prof.stall_burst(window_s=60.0)
            assert prof.counter_track(bucket_s=0.5)
            views += 1
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        feeder.join(5.0)
    assert not feeder.is_alive()
    assert views > 10


def test_profiler_start_stop_reset_lifecycle(pkg):
    P, C = pkg.profiler, pkg.clock
    prof = P.SamplingProfiler(hz=97.0)
    assert not prof.running
    try:
        assert prof.start()
        assert prof.start()  # idempotent
        assert prof.running
        wait_until(lambda: prof.passes >= 3 or None, timeout=5,
                   message="sampling passes")
    finally:
        prof.stop()
    assert not prof.running
    assert prof.passes >= 3 and prof.samples > 0
    prof.reset()
    assert prof.passes == 0 and prof.samples == 0
    assert prof.folded_counts() == {} and len(prof.ring) == 0


def test_profiler_refuses_simulated_clock(pkg):
    P, C = pkg.profiler, pkg.clock
    class FakeClock:
        def time(self):
            return 0.0

        def monotonic(self):
            return 0.0

    prof = P.SamplingProfiler(hz=50.0)
    prev = C.install(FakeClock())
    try:
        assert C.is_simulated()
        assert prof.start() is False
        assert not prof.running
    finally:
        C.install(prev)
    # hz <= 0 refuses too
    assert P.SamplingProfiler(hz=0.0).start() is False


def test_sampling_overhead_is_small(pkg):
    P, C = pkg.profiler, pkg.clock
    """Lenient unit-level overhead gate (the strict 5% end-to-end gate
    lives in `bench.py --profile-smoke`): a fixed CPU workload with the
    sampler running at 19 Hz must not take wildly longer than without."""

    def work():
        t0 = time.perf_counter()
        acc = 0
        for i in range(400_000):
            acc += i * i
        return time.perf_counter() - t0

    off_times, on_times = [], []
    prof = P.SamplingProfiler(hz=19.0)
    for _ in range(3):  # interleaved trials absorb machine noise
        off_times.append(work())
        assert prof.start()
        try:
            on_times.append(work())
        finally:
            prof.stop()
    assert min(on_times) < min(off_times) * 2.0, (
        f"sampling overhead too high: on={on_times} off={off_times}"
    )


# ----------------------------------------------------- across the packages
@pytest.mark.parametrize("seed", range(3))
def test_folded_output_equal_across_packages(seed):
    """Both tries, fed the same seeded stacks under a tight node budget,
    hold the same counts, drop the same folds into the truncated sink and
    render the same folded text; `diff_counts` agrees on the window."""
    rng = random.Random(seed)
    frames = [f"mod{i}.f{j}" for i in range(6) for j in range(4)]
    tries = [PKGS[n].profiler.FoldedTrie(max_nodes=96) for n in PKGS]
    before = None
    for step in range(400):
        plane = rng.choice(("reactor", "ingest", "fanout", "journal"))
        stack = tuple(rng.choice(frames) for _ in range(rng.randint(1, 6)))
        n = rng.randint(1, 3)
        for trie in tries:
            trie.fold(plane, stack, n)
        if step == 200:
            before = [trie.counts() for trie in tries]
    counts = [trie.counts() for trie in tries]
    assert counts[0] == counts[1]
    assert tries[0].dropped == tries[1].dropped > 0
    assert tries[0].nodes == tries[1].nodes
    renders = [PKGS[n].profiler.render_folded(c)
               for n, c in zip(PKGS, counts)]
    assert renders[0] == renders[1]
    windows = [PKGS[n].profiler.diff_counts(c, b)
               for n, c, b in zip(PKGS, counts, before)]
    assert windows[0] == windows[1]
