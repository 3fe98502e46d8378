"""The command line: no card, no result; only the benchmark's own files,
no result; a new cell from new files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _run(args, cwd, pythonpath, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(BENCH, dst / "hqbench", ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_no_card_no_result(card_absent=None):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run([sys.executable, "hqbench/run.py", "--workload",
                "pto_w16.array_sleep0", "--seed", "1", "--seconds", "1",
                "--trace", "0"], ROOT, str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    dst = _copy(tmp_path)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from hqbench.harness.main import run_cell\n"
            "run_cell('pto_w16.array_sleep0', 1, 1, False, device='cpu')\n")
    out = _run([sys.executable, "-c", code], dst, None)
    assert out.returncode != 0
    assert "hyperqueue_tpu_torch" in out.stderr


def test_a_new_cell_from_new_files_alone(tmp_path):
    dst = _copy(tmp_path)
    before = _digests(dst)
    config = json.loads((dst / "hqbench/configs/pto_w16.json").read_text())
    config["name"] = "toy"
    config["workers"]["count"] = 8
    config["workers"]["choices"] = {"cpus": [4, 8]}
    config["requests"] = {"classes": [[{"cpus": 1}], [{"cpus": 2}]]}
    (dst / "hqbench/configs/toy.json").write_text(json.dumps(config))
    (dst / "hqbench/traffic/toy_burst.json").write_text(json.dumps({
        "why": "a toy loop", "loop": "toy",
        "backlog": {"tasks": 9000, "jobs": 3, "user_priorities": 2,
                    "shape_seed": 1},
        "duration_s": 0.005, "warmup_ticks": 1}))
    # a loop of its own, from a new file
    (dst / "hqbench/loops/toy.py").write_text(
        "from hqbench.loops.closed import Loop as Closed\n\n\n"
        "class Loop(Closed):\n    kind = 'toy'\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "hqbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.toy_burst", "config": "toy",
                               "traffic": "toy_burst", "chips": 1,
                               "why": "a test"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, '.')\n"
            "from hqbench.harness.main import run_cell\n"
            "r, i = run_cell('toy.toy_burst', 7, 0.5, False, device='cpu')\n"
            "print(json.dumps([r['correct'], sorted(r['metrics']), i]))\n")
    out = _run([sys.executable, "-c", code], dst,
               f"{dst}{os.pathsep}{ROOT}")
    assert out.returncode == 0, out.stderr
    correct, metrics, info = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert info["loop"] == "toy"
    assert {"setup_s", "tasks_started_per_s"} <= set(metrics)
    assert info["ticks_checked"] >= 2
    after = _digests(dst)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
