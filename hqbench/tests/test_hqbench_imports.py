"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port either. Top-level module names are compared
whole (the part before the first dot): the port's name begins with the
JAX package's."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BARRED = {"jax", "jaxlib", "flax", "hyperqueue_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_barred_import(path):
    names = top_level_imports(path)
    assert not names & BARRED, f"{path} imports {names & BARRED}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "hyperqueue_tpu_torch" not in names, (
            f"{path}: the reference imports the port")


def _child_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in "
         "sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    mods = _child_modules(
        "import hqbench.run, hqbench.control\n"
        "import hqbench.harness.main, hqbench.harness.cell\n"
        "import hqbench.harness.traffic, hqbench.harness.trace\n"
        "import hyperqueue_tpu_torch.convert\n"
        "import hyperqueue_tpu_torch.models.greedy\n"
        "import hyperqueue_tpu_torch.scheduler.watchdog\n"
        "import hyperqueue_tpu_torch.server.reactor\n"
        "import hyperqueue_tpu_torch.server.bootstrap\n"
        "import hyperqueue_tpu_torch.server.lazy\n"
        "import importlib, pathlib\n"
        "for p in sorted(pathlib.Path('hqbench/metrics').glob('*.py')):\n"
        "    importlib.import_module('hqbench.metrics.' + p.stem)\n")
    assert not mods & BARRED, mods & BARRED


def test_reference_loads_nothing_of_the_port():
    mods = _child_modules(
        "import hqbench.reference.check, hqbench.reference.tick\n"
        "import hqbench.reference.cut_scan\n")
    assert not mods & (BARRED | {"hyperqueue_tpu_torch"}), mods
