"""The port stands alone: no file of hyperqueue_tpu_torch/ and not
chip_smoke.py imports jax or anything of the JAX package, and without CUDA
the default model refuses to start instead of solving on the CPU.

The import check reads the sources with `ast`: a check of sys.modules would
prove nothing where the interpreter preloads jax at start-up.
"""

import ast
from pathlib import Path

import pytest
import torch

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each
# of them starves the other workers (and their wall-clock gates)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "hyperqueue_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                names.append(node.module)
            elif node.level > 0:
                names.append("." * node.level + (node.module or ""))
    return names


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("ops/assign.py", "ops/probe.py", "scheduler/tick.py",
                   "scheduler/tick_cache.py", "scheduler/pipeline.py",
                   "scheduler/watchdog.py", "server/core.py",
                   "server/worker.py", "resources/descriptor.py",
                   "resources/worker_resources.py", "utils/clock.py",
                   "utils/native.py", "models/greedy.py",
                   "models/multichip.py", "models/milp.py",
                   "scheduler/oracle.py", "scheduler/decision.py",
                   "parallel/solve.py", "convert.py",
                   "server/task.py", "server/jobs.py", "server/lazy.py",
                   "server/protocol.py", "server/reactor.py",
                   "scheduler/queues.py", "utils/metrics.py",
                   "utils/trace.py", "utils/flight.py",
                   "transport/framing.py", "transport/codec.py",
                   "events/journal.py", "events/outputlog.py",
                   "events/snapshot.py", "events/restore.py",
                   "server/journal_plane.py", "server/accounting.py",
                   "server/bootstrap.py", "server/ingest.py",
                   "server/fanout.py", "transport/auth.py",
                   "transport/aead.py", "transport/_chacha.py",
                   "transport/_chacha_np.py", "transport/_chacha_ossl.py",
                   "utils/serverdir.py", "utils/slo.py",
                   "utils/profiler.py"):
        assert f"hyperqueue_tpu_torch/{module}" in names, module
    for source in ("csrc/cut_scan.cu", "csrc/cut_scan_step.cuh",
                   "csrc/sharded_scan.cu", "csrc/sync_probe.cu",
                   "native/hqcore.cpp"):
        assert (ROOT / "hyperqueue_tpu_torch" / source).exists(), source


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_and_no_jax_package_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax"), f"{path}: {name}"
        # the port's files encode with its own codec (transport/codec)
        assert top != "msgpack", f"{path}: imports {name}"
        assert top != "hyperqueue_tpu", f"{path}: imports {name}"
        # relative imports stay inside the port's own package
        assert not name.startswith("."), f"{path}: relative {name}"


def test_default_model_raises_without_cuda(monkeypatch):
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GreedyCutScanModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        GreedyCutScanModel(device="cuda:0")
    assert GreedyCutScanModel(device="cpu").device.type == "cpu"


def test_card_entry_points_default_to_the_card(monkeypatch):
    """The probe and the models ask for the card unless told otherwise, and
    the model solves there on every solve unless asked for "auto" or
    "numpy". The watchdog's host fallback stands in only for a primary off
    the card, or where the caller passes one."""
    import inspect

    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.models.multichip import MultichipModel
    from hyperqueue_tpu_torch.ops.probe import sync_round_trip_ms
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
    from hyperqueue_tpu_torch.server.bootstrap import Server

    for fn in (GreedyCutScanModel.__init__, MultichipModel.__init__,
               sync_round_trip_ms, Server.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(GreedyCutScanModel.__init__) \
        .parameters["backend"].default == "device"
    card_primary = type("CardPrimary", (), {"device": torch.device("cuda")})
    assert SolverWatchdog(card_primary()).fallback is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverWatchdog(GreedyCutScanModel())
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(server_dir="/nonexistent")
    fallback = SolverWatchdog(object()).fallback
    assert (fallback.device.type, fallback.backend) == ("cpu", "numpy")
