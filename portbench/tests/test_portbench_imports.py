"""What a run and the references may load, by whole top-level module names:
``palace_tpu_torch`` starts with ``palace_tpu`` and is not it."""
import subprocess
import sys
import types

from portbench.harness import cell

ROOT = str(cell.ROOT)


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); "
                          f"{code}; print(' '.join(sorted({{m.split('.')[0] for m in "
                          f"sys.modules}})))"],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_references_load_nothing_of_the_program():
    names = loaded_after("import portbench.reference.gcn, portbench.reference.eref")
    assert not names & {"palace_tpu_torch", "palace_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    names = loaded_after("from portbench.tests import _tiny; "
                         "assert _tiny.run(_tiny.parts('eref'))['correct']")
    assert "palace_tpu_torch" in names
    assert not names & {"palace_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    before = set(cell.forbidden_modules())
    for name in ("palace_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(cell.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "palace_tpu.ops", types.ModuleType("palace_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"palace_tpu", "jax"} <= set(cell.forbidden_modules())
