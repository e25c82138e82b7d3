"""The port stands alone: no module of yolojax_torch, not chip_smoke.py, not
the card's tests (``tests/test_torch_cuda_*.py``, which run where JAX is not
installed) and not the distributed tests' rank bodies
(``tests/torch_dist_ranks.py``, which spawned ranks import) imports the JAX
package or jax.

Each file's AST is walked for ``import yolojax…``, ``from yolojax…`` and
``import jax…`` / ``from jax…`` (``yolojax_torch`` itself is allowed).  A
second check imports every module of the port in a fresh interpreter in
which importing ``yolojax`` or ``jax`` raises, so an import hidden behind a
call or a string fails too; so does every card test file.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yolojax_torch"
CUDA_TESTS = sorted((ROOT / "tests").glob("test_torch_cuda_*.py"))
# the rank bodies of the distributed tests, which the card's tests import too
RANKS = ROOT / "tests" / "torch_dist_ranks.py"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", RANKS] + CUDA_TESTS
FORBIDDEN = ("yolojax", "jax")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, alias.name) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_the_walk_sees_every_module():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"yolojax_torch/config.py", "yolojax_torch/category.py",
            "yolojax_torch/cli/__init__.py", "yolojax_torch/utils/visualize.py",
            "yolojax_torch/kernels/_build.py", "yolojax_torch/cli/train.py",
            "yolojax_torch/parallel/mesh.py", "yolojax_torch/data/loader.py", "chip_smoke.py",
            "yolojax_torch/eval_ap.py", "yolojax_torch/cli/eval.py", "yolojax_torch/cli/cache.py",
            "yolojax_torch/cli/estimate.py", "yolojax_torch/cli/convert_darknet.py",
            "yolojax_torch/data/voc.py", "yolojax_torch/data/coco.py",
            "yolojax_torch/data/synth.py", "yolojax_torch/tools/darknet.py",
            "yolojax_torch/tools/kmeans.py", "tests/test_torch_cuda_kernels.py",
            "tests/test_torch_cuda_nms_pool_reorg.py", "tests/test_torch_cuda_eval.py",
            "yolojax_torch/native/__init__.py", "yolojax_torch/entry.py",
            "yolojax_torch/kernels/ops.py", "yolojax_torch/cli/export.py",
            "yolojax_torch/cli/prune.py", "yolojax_torch/cli/demo_data.py",
            "yolojax_torch/cli/demo_graph.py", "yolojax_torch/cli/receptive_field.py",
            "yolojax_torch/tools/onnx_export.py", "yolojax_torch/tools/prune.py",
            "tests/test_torch_cuda_deploy.py", "yolojax_torch/parallel/collectives.py",
            "yolojax_torch/data/device_cache.py", "tests/test_torch_cuda_dist.py",
            "yolojax_torch/tools/bench.py", "yolojax_torch/tools/sustained_bench.py"} <= names
    assert not any(_forbidden(name) for _, name in _imports(ROOT / "yolojax_torch" / "__init__.py"))
    # the check itself: a forbidden import is found, the port's own is not
    assert _forbidden("yolojax.config") and _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("yolojax_torch.config") and not _forbidden("jaxlib_free")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_module_imports_nothing_of_jax_or_yolojax(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCKER = """
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yolojax", "jax"):
            raise ImportError(f"the port imported {name}")
sys.meta_path.insert(0, Block())
for name in [m for m in sys.modules if m.split(".")[0] in ("yolojax", "jax")]:
    del sys.modules[name]  # a start-up hook may have imported them already
sys.path.insert(0, sys.argv[1])
import yolojax_torch
for info in pkgutil.walk_packages(yolojax_torch.__path__, "yolojax_torch."):
    importlib.import_module(info.name)
import chip_smoke
sys.path.insert(0, sys.argv[1] + "/tests")
for name in sys.argv[2:]:
    importlib.import_module(name)
from yolojax_torch.cli import common, detect, make_parser, setup
from yolojax_torch.config import parse_attr, parse_attr_list
config = setup(make_parser("x").parse_args(["-m", "model/pallas=nms fusedpost pool"]))
category, anchors, model = common.build(config)
assert len(category) == 20 and anchors.shape == (5, 2)
assert [m.__name__ for m in parse_attr_list(config.get("cache", "datasets"))] == \
    ["yolojax_torch.data.voc"]
assert parse_attr("yolojax.data.coco").__name__ == "yolojax_torch.data.coco"
print("standalone", type(model).__name__)
"""


def test_the_port_imports_and_builds_with_yolojax_and_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKER, str(ROOT), *(p.stem for p in CUDA_TESTS)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "standalone Darknet" in proc.stdout
