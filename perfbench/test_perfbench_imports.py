"""Nothing the harness runs loads JAX or the JAX package, and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from perfbench.harness.cell import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "yolojax"}


def test_a_harness_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from perfbench.conftest import small_run\n"
        "small_run('darknet19-voc416.detect-b128')\n"
        "small_run('darknet19-voc416.train-b16')\n"
        "import perfbench.run, perfbench.harness.trace\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "yolojax_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.lstrip(".").split(".")[0]
            assert top not in FORBIDDEN | {"yolojax_torch", "perfbench"}, (path, name)
            assert not name.startswith(".."), (path, name)


def test_no_harness_file_imports_jax_or_the_tools():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert not name.startswith("yolojax_torch.tools") and name != "chip_smoke", (path, name)
