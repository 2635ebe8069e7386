"""The port imports neither JAX nor any module of palace_tpu.

A name check has to see whole module names: ``palace_tpu_torch`` starts
with ``palace_tpu`` and is allowed."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import palace_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "palace_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
#: what the spawned ranks of the port's multi-process tests import: no JAX
RANK_FILES = ["tests/_torch_parallel_worker.py", "tests/_torch_eref_worker.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "palace_tpu")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_forbidden_name_check_sees_whole_module_names():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("palace_tpu")
    assert _forbidden("palace_tpu.ops.encoder")
    assert not _forbidden("palace_tpu_torch") and not _forbidden("palace_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like_name")


@pytest.mark.parametrize("path", PORT_FILES + RANK_FILES)
def test_no_jax_or_palace_tpu_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        palace_tpu_torch.__path__, "palace_tpu_torch.") if not m.name.endswith("__main__"))
    assert {"palace_tpu_torch.ops.kernels", "palace_tpu_torch.cli", "palace_tpu_torch.config",
            "palace_tpu_torch.ops.count_table", "palace_tpu_torch.search.eref",
            "palace_tpu_torch.search.refs", "palace_tpu_torch.io.fastq_native",
            "palace_tpu_torch.native._build", "palace_tpu_torch.graph.native",
            "palace_tpu_torch.matching.solver", "palace_tpu_torch.assembly.path_fa",
            "palace_tpu_torch.filters.dedup", "palace_tpu_torch.filters.final_fa",
            "palace_tpu_torch.pipeline.driver", "palace_tpu_torch.pipeline.stages",
            "palace_tpu_torch.pipeline.external", "palace_tpu_torch.models.train",
            "palace_tpu_torch.models.checkpoint", "palace_tpu_torch.parallel",
            "palace_tpu_torch.parallel.mesh", "palace_tpu_torch.parallel.collectives",
            "palace_tpu_torch.parallel.distributed"} <= set(modules)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'palace_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")
