"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port; the command refuses to run without a card or
without the port."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import harness as H

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
PLAIN = ("reference", "weights.py", "loadgen.py", "stats.py",
         "roofline.py", "metrics")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.serve.engine", "reproX", "jax",
             "jax.numpy", "jaxlib.xla", "flax", "repro", "repro.kernels",
             "jaxtyping", "numpy"]
    assert H.forbidden_modules(names) == ["flax", "jax", "jax.numpy",
                                          "jaxlib.xla", "repro",
                                          "repro.kernels"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in H.FORBIDDEN, (path, mod)


def test_the_yardstick_imports_nothing_of_the_port():
    for part in PLAIN:
        for path in ([BENCH / part] if part.endswith(".py")
                     else (BENCH / part).rglob("*.py")):
            for mod in _imports(path):
                assert mod.split(".")[0] != "repro_torch", (path, mod)


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen2-1.5b.longprompt", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == "", r.stdout


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _command(ROOT, env)
    assert r.returncode != 0 and r.stdout.strip() == "", r.stdout
